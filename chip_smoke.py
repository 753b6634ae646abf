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
   main path gave it most often, launches of phases 7 to 11 and 14 included, each
   kernel at its own launch geometry (the process tuner is empty again);
   ``scoring`` has one entry for each path
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
9. Autotuning (runs after 8, before the kernels line of 6), at
   ``ModelConfig()`` width on phase 4's graph as phase 8 generated it. (a) A
   fresh ``KernelTuner`` with a cache file (``iters`` 3, ``warmup`` 1, the
   reference's defaults) sweeps ``tune_for_model``'s buckets for BetaE and
   GQE+H_sem at ``TrainConfig()``'s batch and b_max (``intersect`` at k = 2
   and 3 over pools 8 to 512, ``scoring`` at 512 × 14,951, ``gather_fuse`` at
   the 512-row EMBED bucket) and serving's shapes (``scoring`` at 16 × 14,951
   and the 4,096-row chunk; ``gather_fuse`` at 128 rows, the chunk and
   n = E), one line a bucket: the kernel's own choice and the tuned one with
   their µs, the candidates and the rejects. Gates: no candidate rejected
   (each bitwise the default), every tuned time at most its default's, every
   entry keyed by the card's name; a second tuner on the file loads every
   entry and sweeps nothing; an empty tuner's lookup under 2 µs a launch.
   Each bucket tuned away from the default has every candidate timed again
   by the kernels line's protocol (printed). (b) BetaE and GQE+H_sem
   (resident) pooled sync training under the tuned policy on phase 5's
   batches: the losses within 1e-4 of phase 5's untuned run (whether bitwise
   printed), then a second pass over the same batches with launches equal
   to the plans' ops and no schedule or encode signature miss; ``pad_waste``
   under the policy beside pow2 padding's. (c) ``launch.train --autotune
   --autotune-cache F`` (BetaE, 3 steps) sweeps only the buckets F lacks;
   ``launch.serve --autotune-cache F`` (GQE+H_sem, phase 4b's store behind a
   hot set of every row) loads F and sweeps nothing. (d) Tuned against
   untuned pooled BetaE steps/s in ten alternating pairs (printed, not
   gated).
10. Distribution (runs after 9, before the kernels line of 6), at
   ``ModelConfig()`` width on phase 4's graph and phase 5's batches, the
   ranks spawned from this script (``_phase10_rank``; any rank's failure or
   a 300 s limit fails the run), after checking that no engine batcher or
   prefetcher thread of phases 7-9 is alive. (b) Two gloo ranks on the one
   card, ``data=2``, fsdp: BetaE and GQE+H_sem through a hot set, 8 steps,
   with the entity rows padded to 14,952 as the launcher pads them to the
   mesh: losses within 1e-3 of a single-device run of that configuration
   here; after step 1, each rank's Adam m shards (0.1 of the gradient the
   trainer reduced) norm-wise within the first-step tolerance (1e-4; BetaE
   1e-3) of the single-device step's, its v shards within twice that, its
   parameter shards within 2 lr, exact-zero gradients still rounding; each
   rank holding half the entity rows and of their moments, both hot sets
   bitwise equal, each rank's launches equal to its plans' ops. (c) The pair at ``data=1,
   model=2``, 2d: entity rows split over model, the whole batch on both
   ranks, losses within 1e-3. (f) ``compressed_psum`` on CUDA tensors
   bitwise its formula; (g) ``gpipe_forward`` over ``pod=2`` within 1e-5 of
   the sequential loop, its point-to-point ops staged through host tensors
   (gloo cannot send CUDA memory; counted and printed). (a) One NCCL rank,
   ``data=1``, fsdp: BetaE and GQE+H_sem resident, sync and pipelined,
   losses bitwise phase 5's and 5c's; (d) (b)'s checkpoint restored there,
   parameters, moments and step bitwise; (f) on NCCL. (e) ``torchrun
   --nproc-per-node 1 -m repro_torch.launch.train --mesh data=1`` (BetaE,
   3 steps). Printed, not gated: steps/s a rank, dispatch ms a step (a sum
   above the timed steps' wall fails) and collective ms a step beside the
   single-device ones, with the card's name and power limit.
11. Serving under a mesh (runs after 10, before the kernels line of 6), at
   ``ModelConfig()`` width on phase 4's graph (entity rows padded to 14,952
   for two ranks), H_sem from phase 4b's store, 128 requests a family in a
   warm-up pass and a timed pass, the ranks spawned from this script
   (``_phase11_rank``). One NCCL rank (``data=1``, fsdp) and two gloo ranks
   sharing the card (``data=2`` fsdp, ``data=1,model=2`` 2d), for BetaE,
   GQE and GQE+H_sem through the hot set, one engine: rank 0 submits, the
   other rank follows; every rank's answers bitwise equal (a digest), equal
   to ``serve_batch`` (under the mesh) on the engine's compositions; one
   rank bitwise the single-device ``serve_batch`` (answers and raw scores),
   two ranks within rtol 1e-4, atol 1e-4·d of it and top-k ids equal where
   the gap after a position exceeds that; each rank's ``scoring``,
   ``intersect`` and ``gather_fuse`` launches equal its plans' ops; half
   the entity rows a rank at two. ``--replicas 2`` (BetaE, GQE) behind a
   ``Router``: the same gates a replica. ``torchrun --nproc-per-node 1 -m
   repro_torch.launch.serve --mesh data=1`` (GQE). Printed, not gated: QPS
   and p99 of the timed pass beside single-device's, collectives and bytes.
12. The LM zoo (after 11). (a) Each of the ten ``reduced_config``
   architectures (B 2, S 32): forward logits with compute in fp32 on the
   card within rtol 1e-4, atol 1e-4 of the CPU path's on the same weights;
   and one fp32 train step's Adam m, every leaf within 1e-3 of its norm of
   the CPU's; in bf16 one train step (its loss within 5e-2 of the CPU's,
   the embedding moved), prefill and decode (finite); for every one decode
   after prefill against forward (the reference's rtol 5e-2, atol 5e-1; MoE
   at capacity 8, whisper with encoder frames, llava from embeddings). (b) At full
   published width: qwen2-0.5b (24 layers), mamba2-1.3b (48) and
   whisper-large-v3 (32 + 32) train 3 steps of 1,024 tokens; mixtral-8x22b
   cut to 4 layers and jamba-v0.1-52b to 8 (one hybrid block); each prints
   its reckoned bytes first (parameters, and with gradients and both Adam
   moments: it trains only where that is at most 60 GB), then prefills
   1,024 tokens and decodes 16, finite, with tokens/s and
   ``torch.cuda.max_memory_allocated``. The whole run's seconds follow.
13. The LM zoo over a mesh and its dry run (after 12). (a) One NCCL rank
   (``data=1``, 2d and fsdp; one rank's shards are its whole tensors):
   qwen2-0.5b's train step, prefill and decode and mixtral-8x22b's (4
   layers) prefill and decode at phase 12 (b)'s sizes bitwise the
   single-device steps. Two gloo ranks on the card (``data=1,model=2`` 2d,
   ``seq_shard`` off and on, one row; ``data=2`` fsdp, two rows), each of the
   ten reduced architectures (mixtral and jamba in ``moe_mode`` tp and ep)
   with compute in fp32: each rank's forward, prefill and decode logits
   within rtol 1e-4, atol 1e-4 of single-device steps on its rows, its loss
   within 1e-4 of the rows' mean, the whole step-1 Adam m (gathered) within
   phase 12's 1e-3 of its norm of the rows' mean; every ``ProcessMesh``
   counter equal to a ``VirtualMesh``'s of the same shape and rank over the
   same program on meta tensors. (b) The dry run on a 1×1 virtual mesh of
   qwen2-0.5b, mamba2-1.3b and whisper-large-v3's train step and
   mixtral-8x22b's (4 layers) prefill, batch 1 × 1,024: its FLOPs equal to
   ``FlopCounterMode``'s count of the same step on the card, its peak within
   1% of the step's own ``torch.cuda.max_memory_allocated`` (less what was
   allocated before its parameters), the measured step time beside three
   bounds reckoned from the H100's published peaks (the dry run's, whose
   memory term is eager traffic; compute alone; minimal bytes), with the
   card's name and power limit. (c) ``launch.dryrun`` on this host over
   ``PHASE13_SUBSET``, always (every architecture and shape, single-pod
   and multi-pod; the full sweep takes longer than 180 s), and the NGDB cell
   dense and sparse: one line a cell (peak a device, dominant term, bound)
   and the seconds.
14. Live writes, background fine-tunes and hot swaps under a mesh (after
   13, before the kernels line of 6), at ``ModelConfig()`` width on phase
   4's graph (rebuilt for every run; entity rows padded to the mesh), the
   ranks spawned from this script (``_phase14_rank``; any rank's failure or
   a 300 s limit fails the run). (a) One NCCL rank (``data=1``, fsdp), GQE
   behind ``ServingEngine(kg=, mat_cache=MaterializedSubqueryCache(2048),
   max_staleness_versions=4)`` and ``LiveNGDB(finetune_steps=4,
   n_negatives=8)``: a deterministic script (whole 16-request batches,
   pinned ones among them, 16 shed stale; four flushed bursts of 64 fresh
   triples, the second adding 16 entities) bitwise the same script
   single-device in the same process (answers, the params after the growth
   and each fine-tune, graph versions, counters); then a closed loop of 32
   over 448 requests (a quarter pinned up to 6 versions behind) while a
   writer thread lands 8 bursts (burst 4 adding 16 entities): every
   request served or shed with ``StaleVersionError``, fresh queries pinned
   after the growth replay bitwise through ``serve_batch(ctx=)`` on the
   retained params and entity count, the params after ``flush()`` bitwise a
   sync ``incremental_finetune(ctx=)`` of burst 8; ``scoring`` launched.
   (b) Two gloo ranks on the card, ``data=2`` fsdp and ``data=1,model=2``
   2d, GQE and BetaE, the same script: both ranks' answers and gathered
   params bitwise equal (a digest); against single-device on the same
   padding, answers within rtol 1e-4, atol 1e-4·d (plus the 3-place
   rounding), top-k ids equal where the gap allows, each fine-tune's update
   within 5% of its norm (``PHASE14_UPDATE_TOL``; the element-wise excess
   over ``test_torch_live.py``'s tolerance printed), the grown rows bitwise;
   each rank holding half of the grown table; ``scoring`` (GQE) and
   ``intersect`` (BetaE) launched. (c) GQE with resident H_sem (d_l 1024,
   random rows in a store of its own) on the NCCL rank: one growth burst
   with ``sem_rows`` appends the store once, rows read before it read back
   bitwise, the new rows as written; ``gather_fuse`` and its backward
   launched as often as the plans call for. (d) ``ReplicaPool(2)`` behind a
   ``Router`` on the NCCL rank and on two gloo ranks (``data=2``):
   ``update_params`` between two halves of a stream (the first half still
   queued; a follower stages its params before it follows): on every rank
   the first half's batches ran on the old params and the second's on the
   new, each bitwise ``serve_batch`` on its params, the ranks bitwise
   equal. (e) ``torchrun --nproc-per-node 1 -m repro_torch.launch.serve
   --mesh data=1 --live-writes 2 --max-staleness 2 --materialize 2048``
   (GQE). Printed, not gated, with the card's name and power limit: QPS and
   p99 through writes beside the single-device run of the same call,
   fine-tune ms a burst, lane hold ms a write, fine-tune and swap,
   collectives and bytes a write (the growth's re-block among them), the
   phase's seconds. The ranks' launches are added to the kernels line.
15. Serving a trained checkpoint, and the example drivers (after 14, before
   the kernels line of 6), at ``ModelConfig()`` width on the FB15k-shaped
   graph. (a) ``launch.serve --ckpt-dir --answers`` in this process on
   phase 8's checkpoints (BetaE at step 28, 12 steps and 16 resumed;
   GQE+H_sem through phase 4b's store at step 12, served through a
   2,048-row hot set, not training's budget; a short ``launch.train
   --ckpt-dir`` writes them where they are missing): every answered micro-batch bitwise ``serve_batch`` on the
   checkpoint's params read apart from the CLI (``load_checkpoint`` into
   ``params_from_numpy``), other answers than the same CLI's without
   ``--ckpt-dir``; BetaE through ``--replicas 2`` the same. (b) ``torchrun
   --nproc-per-node 1 -m repro_torch.launch.serve --mesh data=1 --profile
   fsdp --ckpt-dir`` (NCCL): its answers bitwise single-device
   ``serve_batch``'s; two gloo ranks on the card (``data=2`` fsdp,
   ``_phase15_rank``) restore both single-device checkpoints with the
   entity rows padded from 14,951 to 14,952: each rank holds its block of
   the checkpoint's rows (the padding row its own), the ranks' answers to
   (a)'s compositions bitwise equal and within phase 14 (b)'s answer
   tolerance of (a)'s. (c) ``launch.e2e --dim 400`` (crash at step 60,
   ``resumed at step 60``, evaluate, ``serve_batch``), ``launch.
   semantic_fusion`` (``kernel == model fusion: True``) and ``launch.lm_zoo
   --arch qwen2-0.5b`` on the card. (d) ``scoring``, ``intersect`` and
   ``gather_fuse`` launched in (a) and (b), ``intersect_backward`` and
   ``gather_fuse_backward`` in (c); the serving CLIs', the gloo ranks' and
   ``launch.e2e``'s launches are added to the kernels line.
16. The last line: ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

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
    t_run = time.perf_counter()
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
                for op, arity, pn in executor.prepare(rec.queries).meta:
                    if op in (int(OpType.INTERSECT), int(OpType.UNION)):
                        shapes[(pn, arity)] += 1
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
    kg0, obs_work = phase8(torch, dev, kops, main_path, batches, tcfg, cfg, sem_cfg, store,
                           budget, sem_dir, pipelined_losses)

    # --------------------------------------------- 9. autotuning on the card
    phase9(torch, dev, kops, main_path, kg0, batches, tcfg, cfg, sem_cfg, store, sem_dir,
           sync_runs, attn_calls, fuse_calls)

    # ------------------------------------------------- 10. distribution
    phase10(torch, dev, main_path, kg0, batches, tcfg, store, sem_dir, budget, sync_runs,
            pipelined_losses)

    # ----------------------------------------------- 11. serving under a mesh
    phase11(main_path, sem_dir, card)

    # ------------------------------------------------------- 12. the LM zoo
    phase12(torch, dev, card)

    # --------------------------------------- 13. the LM zoo over a mesh, dry run
    phase13(torch, dev, card)

    # ------------------- 14. live writes and hot swaps under a mesh
    phase14(main_path, card)

    # ------------- 15. serving a trained checkpoint, and the example drivers
    phase15(torch, dev, main_path, obs_work, sem_dir, card)
    print(f"chip_smoke: whole run {time.perf_counter() - t_run:.1f} s")

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
    return kg0, work


def phase9(torch, dev, kops, main_path, kg0, batches, tcfg, cfg, sem_cfg, store, sem_dir,
           sync_runs, attn_calls, fuse_calls) -> None:
    """Autotuning on the card (module docstring, 9): sweeps at full width
    into a cache file, pooled training under the tuned policy, the CLIs with
    the file, and tuned against untuned steps/s. The process tuner is empty
    again afterwards, so the kernels line times the kernels' own choices.
    Launches of (b)-(d) are added to ``main_path``."""
    import contextlib
    import io

    from repro_torch.core.compiler import compile_batch
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels.timing import flush_buffer, intersect_inputs, time_ms
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models import make_model
    from repro_torch.training import NGDBTrainer

    t9 = time.perf_counter()
    others = sorted(t.name for t in threading.enumerate() if t is not threading.main_thread())
    print(f"phase 9: threads besides the main one (they share its GIL while it times): "
          f"{others or 'none'}")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tune_"))
    atexit.register(shutil.rmtree, str(work), ignore_errors=True)
    path = str(work / "tiles.json")
    kind = torch.cuda.get_device_name(dev)
    counted = ("intersect", "intersect_backward", "gather_fuse", "gather_fuse_backward",
               "scoring")
    added = collections.Counter()   # main-path key -> phase 9 launches
    empty = at.KernelTuner()
    prev = at.set_tuner(empty)

    def counts() -> dict:
        return {name: getattr(kops, name).launches for name in counted}

    def zero() -> None:
        for name in counted:
            getattr(kops, name).launches = 0

    # (a) Sweeps at full width into a fresh cache file: the reference's
    # tune_for_model buckets for BetaE and GQE+H_sem at TrainConfig()'s batch
    # and b_max, and serving's scoring and gather_fuse shapes.
    dim, dl, dp = cfg.dim, sem_cfg.semantic_dim, sem_cfg.semantic_proj_dim
    E = FB15K[0]
    models = {"betae": make_model("betae", cfg, device=dev),
              "gqe+H_sem": make_model("gqe", sem_cfg, device=dev)}
    extra = [("scoring", at.scoring_bucket(16, E, dim)),
             ("scoring", at.scoring_bucket(16, CHUNK, dim)),
             ("gather_fuse", at.gather_fuse_bucket(128, dim, dl, dp)),
             ("gather_fuse", at.gather_fuse_bucket(CHUNK, dim, dl, dp)),
             ("gather_fuse", at.gather_fuse_bucket(E, dim, dl, dp))]

    def tune_all(tuner) -> int:
        n = sum(at.tune_for_model(m, tuner, b_max=tcfg.b_max, batch=tcfg.batch_size,
                                  n_entities=E, device=dev) for m in models.values())
        before = int(tuner.sweeps)
        for op, bucket in extra:
            tuner.tune(op, bucket, device=dev)
        return n + int(tuner.sweeps) - before

    tuner = at.KernelTuner(path=path)   # iters 3, warmup 1: the reference's defaults
    t0 = time.perf_counter()
    n_sweeps = tune_all(tuner)
    sweep_s = time.perf_counter() - t0
    entries = tuner.entries()
    knob = {"scoring": "tile", "intersect": "rows", "gather_fuse": "rows"}
    tuned = 0
    for key, e in sorted(entries.items(), key=lambda kv: (kv[1]["op"], kv[1]["bucket"])):
        name = knob[e["op"]]
        c = e["config"][name]
        tuned += c != 0
        print(f"phase 9 (a) {e['op']} {'x'.join(map(str, e['bucket']))} {e['dtype']}: "
              f"default {name}={e['default']} {e['default_us']:.2f} us | tuned "
              f"{name}={c or e['default']}{' (the default)' if c == 0 else ''} "
              f"{e['us']:.2f} us ({e['us'] / e['default_us']:.3f}x) | "
              f"{e['n_candidates']} candidates, {e['n_rejected']} rejected")
        if e["n_rejected"]:
            fail(f"phase 9 (a) {key}: {e['n_rejected']} candidates not bitwise the default")
        if e["us"] > e["default_us"]:
            # A sanity check: the margin rule admits a challenger only below
            # the default's time, so this holds by construction.
            fail(f"phase 9 (a) {key}: tuned {e['us']} us above the default's "
                 f"{e['default_us']} us")
        if not key.endswith("|" + kind) or e["device"] != kind:
            fail(f"phase 9 (a) {key}: not keyed by the card's name {kind!r}")
    if int(tuner.verify_rejects) or n_sweeps != len(entries):
        fail(f"phase 9 (a): {tuner.stats()} after {n_sweeps} sweeps")
    # Each bucket tuned away from the default, every candidate timed again by
    # the kernels line's protocol (median of 25, L2 flushed before each run)
    # on the sweep's inputs, and for intersect on BetaE-like ones too: the
    # sweep's min of 3 checked (printed, not gated).
    flush = flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(90)
    for key, e in entries.items():
        name, bucket = knob[e["op"]], tuple(e["bucket"])
        if e["config"][name] == 0:
            continue
        inputs = {"sweep": at.make_runner(e["op"], bucket, e["dtype"], dev)}
        if e["op"] == "intersect":
            inputs["BetaE-like"] = (inputs["sweep"][0],
                                    intersect_inputs(*bucket, torch.float32, gen))
        for label, (run, args) in inputs.items():
            ms = {c[name]: time_ms(lambda: run(c, *args), flush)  # noqa: B023
                  for c in at.candidates(e["op"], bucket, e["default"])}
            print(f"phase 9 (a) {key}, {label} inputs, median of 25 a candidate: "
                  + ", ".join(f"{name}={v or e['default']}{' (default)' if v == 0 else ''} "
                              f"{t * 1e3:.2f} us" for v, t in ms.items()))
    del flush
    again = at.KernelTuner(path=path)
    if again.load_error or len(again) != len(entries):
        fail(f"phase 9 (a): a second tuner loaded {len(again)} of {len(entries)} entries "
             f"({again.load_error})")
    if tune_all(again) or int(again.sweeps):
        fail(f"phase 9 (a): a second tuner on the file swept again: {again.stats()}")
    probe = torch.empty(1, device=dev)
    lookup_ns = {}
    for label, t in (("empty", empty), ("tuned", tuner)):
        at.set_tuner(t)
        n = 200_000
        t1 = time.perf_counter()
        for _ in range(n):
            at.tuned_config("intersect", (64, 2, 2 * dim, dim * cfg.hidden_mult), probe)
        lookup_ns[label] = (time.perf_counter() - t1) / n * 1e9
    if lookup_ns["empty"] > 2000:
        fail(f"phase 9 (a): an empty tuner's lookup costs {lookup_ns['empty']:.0f} ns a "
             f"launch (gate 2 us)")
    print(f"phase 9 (a): {n_sweeps} sweeps in {sweep_s:.1f} s ({tuned} of {len(entries)} "
          f"buckets tuned away from the kernel's own choice), every candidate bitwise the "
          f"default, every entry keyed by {kind!r}; a second tuner loaded all "
          f"{len(again)} from the file and swept nothing | a launch's lookup: "
          f"{lookup_ns['empty']:.1f} ns with an empty tuner (gate 2,000), "
          f"{lookup_ns['tuned']:.1f} ns with a hit (mean over {n} calls)")

    # (b) Pooled sync training on phase 5's batches, on phase 4's graph as
    # phase 8 generated it afresh: under the tuned policy, and under a planted
    # one whose entries are not the kernels' own choices, so that forced
    # geometries and kernel-aware padding run on the main path whatever the
    # sweep found (8 pool rows a row group at every BetaE intersect bucket;
    # the other gather_fuse kernel at the b_max EMBED bucket).
    sd = models["betae"].state_dim
    embed_bucket = list(at.gather_fuse_bucket(tcfg.b_max, dim, dl, dp))
    plant = {}
    for key, e in entries.items():
        if e["op"] == "intersect" and e["bucket"][2] == sd:
            plant[key] = dict(e, config={"rows": 8})
        elif e["op"] == "gather_fuse" and e["bucket"] == embed_bucket:
            plant[key] = dict(e, config={"rows": 64 if e["default"] == 128 else 128})
    planted_path = str(work / "planted.json")
    with open(planted_path, "w") as f:
        json.dump({"version": at.CACHE_VERSION, "entries": plant}, f)
    planted = at.KernelTuner(path=planted_path)
    if (planted.load_error or len(planted) != len(plant)
            or {e["op"] for e in plant.values()} != {"intersect", "gather_fuse"}):
        fail(f"phase 9 (b): the planted tuner holds {len(planted)} of {len(plant)} entries "
             f"({planted.load_error})")
    table = np.concatenate([rows for _, rows in store.iter_shards()])
    runs = {}
    for tname, tn in (("tuned", tuner), ("planted", planted)):
        at.set_tuner(tn)
        for label, family, mcfg, key in (("betae", "betae", cfg, ("betae", "pooled")),
                                         ("gqe+H_sem", "gqe", sem_cfg,
                                          ("gqe+semantic [resident]", "pooled"))):
            sem = {"semantic_table": table} if family == "gqe" else {}
            trainer = NGDBTrainer(make_model(family, mcfg, device=dev), kg0, tcfg, **sem)
            policy = trainer.executor.tile_policy
            losses = [r["loss"] for r in trainer.train(len(batches), log_every=0,
                                                       batches=batches)]
            want = sync_runs[key][0]
            if not np.isfinite(losses).all():
                fail(f"phase 9 (b) {tname} {label}: a loss is not finite: {losses}")
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
            if len(losses) != len(want) or rel > 1e-4:
                fail(f"phase 9 (b) {tname} {label}: losses {rel:.3g} relative from phase "
                     f"5's untuned run (rtol 1e-4)")
            # The same batches again: every plan and closure is cached now.
            trainer.executor.reset_cache_counters()
            zero()
            hits = int(tn.lookup_hits)
            trainer.train(len(batches), log_every=0, batches=batches)
            torch.cuda.synchronize()
            hits = int(tn.lookup_hits) - hits
            launched = counts()
            misses = {k: int(c["misses"]) for k, c in trainer.executor.cache_stats().items()}
            real = padded = padded_pow2 = 0
            want_l = collections.Counter()
            for b in batches:
                qs = [x.query for x in b]
                plan = trainer.executor.prepare(qs)
                pow2 = compile_batch(qs, model_name=trainer.model.name, b_max=tcfg.b_max,
                                     cse=tcfg.cse)
                real += sum(st.n for st in plan.sched.steps)
                padded += sum(st.padded_n for st in plan.sched.steps)
                padded_pow2 += sum(st.padded_n for st in pow2.sched.steps)
                if family == "betae":
                    want_l["intersect"] += len(attn_calls(trainer.executor, qs))
                else:
                    embeds, loss_calls = fuse_calls(trainer.executor, qs)
                    want_l["gather_fuse"] += len(embeds) + len(loss_calls)
            fwd, bwd = (("intersect", "intersect_backward") if family == "betae"
                        else ("gather_fuse", "gather_fuse_backward"))
            if ((launched[fwd], launched[bwd]) != (want_l[fwd], want_l[fwd])
                    or any(misses.values())):
                fail(f"phase 9 (b) {tname} {label}: launches {launched} for {want_l[fwd]} "
                     f"ops in the plans; signature misses after warm-up {misses}")
            if tname == "planted" and (policy is None or padded >= padded_pow2 or not hits):
                fail(f"phase 9 (b) planted {label}: policy {policy!r}, {padded} padded rows "
                     f"against {padded_pow2} pow2, {hits} lookups served by a planted entry")
            key_f = "intersect[training]" if family == "betae" else "gather_fuse[training]"
            added[key_f] += launched[fwd]
            added[bwd] += launched[bwd]
            waste, waste_pow2 = 1 - real / padded, 1 - real / padded_pow2
            if tname == "tuned":
                runs[label] = trainer
            print(f"phase 9 (b) {tname} {label}: policy {policy!r}"
                  f"{' ' + str(dict(policy.key())) if policy else ''} | pad_waste "
                  f"{waste:.4f} under it, {waste_pow2:.4f} with pow2 padding ({real} real "
                  f"rows, {padded} padded, {padded_pow2} pow2) over {len(batches)} plans | "
                  f"{len(losses)} losses "
                  f"{'bitwise' if losses == want else f'{rel:.3g} relative from'} phase 5's "
                  f"untuned run | a second pass on the same batches: launches "
                  f"{launched[fwd]} + {launched[bwd]} backward = the plans' {want_l[fwd]} "
                  f"ops, {hits} lookups served by a tuner entry, signature misses {misses}")
    del table

    # (c) The CLIs with the file, in this process so the counts see them.
    def run(label: str, fn, argv) -> str:
        buf = io.StringIO()
        t1 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                fn(argv)
        except Exception as e:
            print(buf.getvalue())
            fail(f"phase 9 (c) {label}: the CLI raised {e!r}")
        out = buf.getvalue()
        print(f"phase 9 (c) {label}: python -m {fn.__module__} {' '.join(argv)} "
              f"({time.perf_counter() - t1:.1f} s)")
        for line in out.splitlines():
            if line.startswith(("autotune:", "trained", "eval:", "qps", "executor caches")):
                print(f"  | {line}")
        return out

    n_file = len(tuner)
    zero()
    out = run("train", train_cli.main,
              ["--model", "betae", "--dim", str(dim), "--steps", "3",
               "--batch-size", str(tcfg.batch_size), "--negatives", str(tcfg.n_negatives),
               "--lr", str(tcfg.adam.lr), "--eval-queries", "64", "--log-every", "0",
               "--autotune", "--autotune-cache", path])
    launched = counts()
    cli_tuner = at.get_tuner()
    n_cli = cli_tuner.stats()["sweeps"]
    # (a) swept every bucket this run's model, graph, batch and b_max hit.
    if ("autotune: 0 sweeps" not in out or cli_tuner.path != path or n_cli
            or len(cli_tuner) != n_file or cli_tuner.stats()["loads"] != 1):
        fail(f"phase 9 (c) train: {cli_tuner.stats()} for a file of {n_file} entries")
    if not launched["intersect"] or not launched["intersect_backward"]:
        fail(f"phase 9 (c) train: launches {launched}")
    added["intersect[training]"] += launched["intersect"]
    added["intersect_backward"] += launched["intersect_backward"]
    zero()
    out = run("serve", serve_cli.main,
              ["--model", "gqe", "--semantic-store", sem_dir, "--semantic-budget-rows",
               str(E), "--requests", "64", "--autotune-cache", path])
    launched = counts()
    served = at.get_tuner().stats()
    if (f"autotune: {n_file} tuned configs loaded from {path}" not in out
            or served["sweeps"] or served["load_error"]):
        fail(f"phase 9 (c) serve: {served}")
    if not launched["gather_fuse"] or not launched["scoring"]:
        fail(f"phase 9 (c) serve: launches {launched}")
    added["gather_fuse[out-of-core]"] += launched["gather_fuse"]
    added["scoring[l1][out-of-core]"] += launched["scoring"]
    print(f"phase 9 (c): the training CLI found all its buckets in the file and swept "
          f"nothing; serving loaded all {n_file} and swept nothing | launches {launched}")

    # (d) Tuned against untuned pooled BetaE steps/s: ten alternating pairs of
    # passes of the same cached batches through two warmed trainers, each
    # pass under its own process tuner (not gated).
    tuned_tr = runs["betae"]
    at.set_tuner(empty)
    plain_tr = NGDBTrainer(make_model("betae", cfg, device=dev), kg0, tcfg)
    if plain_tr.executor.tile_policy is not None:
        fail("phase 9 (d): an empty tuner gave a policy")
    zero()
    plain_tr.train(len(batches), log_every=0, batches=batches)
    steps, ratios = 4, []
    for trial in range(10):
        rate = {}
        for name in (("tuned", "untuned") if trial % 2 == 0 else ("untuned", "tuned")):
            at.set_tuner(tuner if name == "tuned" else empty)
            tr = tuned_tr if name == "tuned" else plain_tr
            part = batches[(trial * steps) % (len(batches) - steps):][:steps]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tr.train(steps, log_every=0, batches=part)
            torch.cuda.synchronize()
            rate[name] = steps / (time.perf_counter() - t1)
        ratios.append(rate["tuned"] / rate["untuned"])
    launched = counts()
    added["intersect[training]"] += launched["intersect"]
    added["intersect_backward"] += launched["intersect_backward"]
    print(f"phase 9 (d) tuned/untuned pooled BetaE steps/s, {steps}-step passes in 10 "
          f"alternating pairs: {' '.join(f'{r:.4f}' for r in ratios)} | median "
          f"{statistics.median(ratios):.4f} (not gated)")
    at.set_tuner(prev)
    del runs, tuned_tr, plain_tr, models
    torch.cuda.empty_cache()

    unknown = set(added) - set(main_path)
    if unknown:
        fail(f"phase 9: launches for keys the kernels line does not have: {sorted(unknown)}")
    for key, n in added.items():
        k_n, counter = main_path[key]
        main_path[key] = (k_n + n, counter)
    print(f"autotuning: launches {dict(added)} added to the kernels line | phase 9 in "
          f"{time.perf_counter() - t9:.1f} s")


# ----------------------------------------------------------- 10. distribution
PHASE10_STEPS = 8          # (b)'s steps a family on two gloo ranks, (c)'s half
RANK_TIMEOUT_S = 300       # any rank's failure or this timeout fails the run


def _phase10_state(tr) -> dict:
    """``tr``'s trainable parameters and Adam moments, on the host."""
    names = [k for k in tr.params if k not in tr.cfg.adam.frozen]
    return {"params": {k: tr.params[k].cpu() for k in names},
            **{part: {k: tr.opt_state[part][k].cpu() for k in names} for part in ("m", "v")}}


def _phase10_step1_gaps(tr, path: str) -> dict:
    """After one step of ``tr`` (a mesh rank), what the trainer's own update
    wrote against the shards ``ctx.shard`` keeps of a single-device step's
    state (``_phase10_state``, saved at ``path``), for each trainable name:
    the norm-wise relative difference of the Adam ``m`` and ``v`` shards,
    and the largest difference of the parameter shard in units of the
    learning rate (a first Adam step moves an element by at most lr, so
    rounding can at most flip one: 2). A name whose gradient is exactly zero
    (the single-device ``m`` at most 1e-6 of the largest) is rounding on
    both sides: its moments get instead the largest ``m`` of the shard over
    that bound ("rounding", at most 1.0 to pass). The rule of
    ``tests/torch_mesh_worker.py::step1_gaps``."""
    import torch

    ref = torch.load(path, map_location=tr.device)
    lr = tr.cfg.adam.lr
    top = max(float(m.abs().max()) for m in ref["m"].values())
    out = {}
    for k in sorted(ref["m"]):
        out["params", k] = float((tr.params[k] - tr.ctx.shard(k, ref["params"][k])).abs().max()) / lr
        if float(ref["m"][k].abs().max()) <= 1e-6 * top:
            out["rounding", k] = float(tr.opt_state["m"][k].abs().max()) / (1e-6 * top)
            continue
        for part in ("m", "v"):
            want = tr.ctx.shard(k, ref[part][k])
            out[part, k] = (float((tr.opt_state[part][k] - want).norm())
                            / max(float(want.norm()), 1e-30))
    return out


def _phase10_plan_calls(tr, kg, batches, n_negatives: int) -> dict:
    """The kernel calls this rank's plans make over ``batches`` (after a run:
    the plans are cached): BetaE's intersections and unions for ``intersect``
    and its backward, a semantic model's EMBED ops plus one loss call a plan
    for ``gather_fuse`` and its backward."""
    from repro_torch.core import OpType
    from repro_torch.data.pipeline import rank_slice
    from repro_torch.sampling import OnlineSampler

    attn = (int(OpType.INTERSECT), int(OpType.UNION))
    calls = collections.Counter()
    sampler = OnlineSampler(kg, seed=0)   # the queries matter here, not the negatives
    for b in batches:
        queries, pos, neg = sampler.to_training_arrays(b, n_negatives)
        if tr.ctx.is_sharded:
            queries = rank_slice(tr.ctx, queries, pos, neg)[1]
        meta = tr.executor.prepare(queries).meta
        n_attn = sum(1 for op, _c, _n in meta if op in attn)
        n_fuse = sum(1 for op, _c, _n in meta if op == int(OpType.EMBED)) + 1
        if tr.model.name == "betae":
            calls["intersect"] += n_attn
            calls["intersect_backward"] += n_attn
        if tr.model.cfg.semantic_dim:
            calls["gather_fuse"] += n_fuse
            calls["gather_fuse_backward"] += n_fuse
    return calls


def _phase10_collective_ms(tr, n: int) -> float:
    """One step's collectives alone, synchronised: the parameter gather and
    the gradient all-reduce of a flat buffer of the trainable names' size
    (median of 3, ms)."""
    import torch

    frozen = set(tr.cfg.adam.frozen)
    size = sum(int(np.prod(s)) for k, s in tr.model.full_shapes.items() if k not in frozen)
    flat = torch.zeros(size, device=tr.device)
    out = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = tr.full_params()
        if tr.ctx.batch_axes(n):
            tr.ctx.reduce_batch(flat, n)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        del full
    return statistics.median(out)


def _phase10_train(tr, kg, batches, n_negatives: int, timed_from: int = 2,
                   timed_to: Optional[int] = None, after_first=None) -> dict:
    """Sync steps on ``batches`` with the kernels' counts zeroed just before
    and read just after: the losses, launches against this rank's plans,
    the mesh's gathered bytes a step, ``after_first(tr)`` after the first
    step, and over ``batches[timed_from:timed_to]`` (after the warm-up,
    which pays for the communicators' set-up) steps/s and the trainer's
    dispatch ms a step (gather, loss, backward, all-reduce, Adam), read from
    its ``phase_seconds{phase=dispatch}`` counter over those steps alone: a
    sum above their wall time fails."""
    import torch

    from repro_torch.kernels import ops as kops

    names = ("intersect", "intersect_backward", "gather_fuse", "gather_fuse_backward")
    torch.cuda.synchronize()
    for name in names:
        getattr(kops, name).launches = 0
    gathered0 = tr.ctx.mesh.bytes["all_gather"] if tr.ctx.is_sharded else 0
    timed_to = len(batches) if timed_to is None else timed_to
    tr.train_step(batches[0])   # no forced checkpoint here, unlike train()
    first = after_first(tr) if after_first is not None else None
    tr.train(timed_from - 1, log_every=0, batches=batches[1:timed_from])
    torch.cuda.synchronize()
    dispatch0 = tr._phase_s["dispatch"].value
    t0 = time.perf_counter()
    for b in batches[timed_from:timed_to]:
        tr.train_step(b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dispatch = tr._phase_s["dispatch"].value - dispatch0
    if not 0 < dispatch <= wall:
        raise RuntimeError(f"phase 10: {dispatch:.3f} s of dispatch over timed steps of "
                           f"{wall:.3f} s")
    for b in batches[timed_to:]:
        tr.train_step(b)
    launches = {name: getattr(kops, name).launches for name in names}
    gathered = ((tr.ctx.mesh.bytes["all_gather"] - gathered0) / len(batches)
                if tr.ctx.is_sharded else 0)
    return {"losses": [r["loss"] for r in tr.history], "launches": launches,
            "want": dict(_phase10_plan_calls(tr, kg, batches, n_negatives)),
            "steps_s": (timed_to - timed_from) / wall, "gathered_bytes": gathered,
            "dispatch_ms": dispatch / (timed_to - timed_from) * 1e3, "first": first}


def _phase10_psum(torch, ctx, world: int) -> dict:
    """``compressed_psum`` of rank-seeded CUDA tensors against its formula
    computed on this rank for every rank's inputs (bitwise)."""
    from repro_torch.training.compression import compressed_psum, dequantize_int8, quantize_int8

    def inputs(r):
        g = np.random.default_rng(r).normal(size=4096).astype(np.float32)
        e = np.random.default_rng(100 + r).normal(scale=0.01, size=4096).astype(np.float32)
        return torch.from_numpy(g).to(ctx.device), torch.from_numpy(e).to(ctx.device)

    g, e = inputs(ctx.mesh.rank)
    out, err = compressed_psum(g, None, e)
    qs = [quantize_int8(gr + er) for gr, er in map(inputs, range(world))]
    summed = sum(q.to(torch.int32) for q, _ in qs)
    max_scale = torch.stack([s for _, s in qs]).max()
    want = summed.to(torch.float32) * max_scale / float(world)
    q, s = qs[ctx.mesh.rank]
    want_err = (g + e) - dequantize_int8(q, s)
    return {"equal": bool(torch.equal(out, want) and torch.equal(err, want_err)),
            "max_abs_err": float((out - want).abs().max())}


def _phase10_rank(rank: int, world: int, backend: str, work: str) -> None:
    """One rank of phase 10 (spawned): on the gloo pair (b), (c), (f), (g);
    alone on NCCL (a), (d), (f). Pickles what it saw to
    ``work/<backend>.r<rank>.pkl``."""
    import datetime
    import hashlib
    import pickle

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{work}/pg_{backend}{world}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.distributed import gpipe_forward, make_execution_context
    from repro_torch.kernels import ops as kops
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.semantic import SemanticCache, SemanticStore
    from repro_torch.training import NGDBTrainer, TrainConfig
    from repro_torch.training.checkpoint import load_checkpoint

    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    batches, budget = inp["batches"], inp["budget"]
    kg = generate_synthetic_kg(*FB15K, seed=0, name="FB15k-shaped")
    store = SemanticStore(inp["sem_dir"])
    tcfg = TrainConfig()
    pad = ModelConfig(entity_pad=2)
    pad_sem = ModelConfig(semantic_dim=SEM_DIM, entity_pad=2)
    ck = os.path.join(work, "ck")
    out = {}
    dev = torch.device("cuda:0")
    if world == 2:
        # (b) data=2, fsdp: BetaE, then GQE+H_sem through a hot set.
        ctx = make_execution_context("data=2", profile="fsdp", device=dev, backend="gloo")
        for label, family, mcfg, hot in (("betae", "betae", pad, False),
                                         ("gqe+H_sem hot set", "gqe", pad_sem, True)):
            cache = SemanticCache(store, budget, ctx=ctx) if hot else None
            cfg = (TrainConfig(checkpoint_dir=ck, checkpoint_every=PHASE10_STEPS)
                   if family == "betae" else tcfg)
            tr = NGDBTrainer(make_model(family, mcfg, device=dev), kg, cfg,
                             **({"semantic_cache": cache} if hot else {}), ctx=ctx)
            path = os.path.join(work, f"step1_{family}.pt")
            r = _phase10_train(tr, kg, batches[:PHASE10_STEPS], tcfg.n_negatives,
                               timed_to=PHASE10_STEPS - 1,
                               after_first=lambda t: _phase10_step1_gaps(t, path))
            r["collective_ms"] = _phase10_collective_ms(tr, tcfg.batch_size)
            r["local"] = {k: tuple(t["entity"].shape) for k, t in
                          (("params", tr.params), ("m", tr.opt_state["m"]),
                           ("v", tr.opt_state["v"]))}
            r["full_rows"] = tr.model.full_shapes["entity"][0]
            if cache is not None:
                r["hot_set"] = (hashlib.sha256(cache.buffer.cpu().numpy().tobytes()).hexdigest(),
                                hashlib.sha256(cache.slot_map.cpu().numpy().tobytes()).hexdigest())
            out[label] = r
            del tr, cache
            torch.cuda.empty_cache()
        out["staged_b"] = ctx.mesh.staged
        # (c) data=1, model=2, 2d: the entity rows over model, the whole
        # batch on both ranks.
        ctx_c = make_execution_context("data=1,model=2", profile="2d", device=dev,
                                       backend="gloo")
        tr = NGDBTrainer(make_model("betae", pad, device=dev), kg, tcfg, ctx=ctx_c)
        r = _phase10_train(tr, kg, batches[:PHASE10_STEPS // 2], tcfg.n_negatives)
        r["local_rows"] = tuple(tr.params["entity"].shape)
        r["rows"] = len(ctx_c.batch_rows(tcfg.batch_size))
        out["c"] = r
        del tr
        torch.cuda.empty_cache()
        out["psum"] = _phase10_psum(torch, ctx, world)
        # (g) gpipe over pod=2 against the sequential loop.
        pp = make_execution_context("pod=2,data=1", device=dev, backend="gloo")
        rng = np.random.default_rng(3)
        w = torch.from_numpy(rng.normal(size=(2, 256, 256)).astype(np.float32) / 16).to(dev)
        bias = torch.from_numpy(rng.normal(size=(2, 256)).astype(np.float32)).to(dev)
        x = torch.from_numpy(rng.normal(size=(8, 32, 256)).astype(np.float32)).to(dev)

        def stage(p, h):
            return torch.tanh(h @ p["w"] + p["b"])

        y = gpipe_forward(stage, {"w": w, "b": bias}, x, pp.mesh)
        want = torch.stack([stage({"w": w[1], "b": bias[1]}, stage({"w": w[0], "b": bias[0]}, xm))
                            for xm in x])
        out["gpipe"] = {"max_abs_err": float((y - want).abs().max()), "staged": pp.mesh.staged,
                        "ok": bool(torch.allclose(y, want, rtol=1e-5, atol=1e-5))}
    else:
        # (a) NCCL at world 1, data=1, fsdp: phase 5's and 5c's runs.
        ctx = make_execution_context("data=1", profile="fsdp", device=dev)
        table = np.concatenate([rows for _, rows in store.iter_shards()])
        for label, family, mcfg, sem in (("betae", "betae", ModelConfig(), {}),
                                         ("gqe+semantic [resident]", "gqe",
                                          ModelConfig(semantic_dim=SEM_DIM),
                                          {"semantic_table": table})):
            for pipeline in (False, True):
                tr = NGDBTrainer(make_model(family, mcfg, device=dev), kg,
                                 TrainConfig(pipeline=pipeline), **sem, ctx=ctx)
                names = ("intersect", "intersect_backward", "gather_fuse",
                         "gather_fuse_backward")
                if pipeline:
                    for name in names:
                        getattr(kops, name).launches = 0
                    losses = [h["loss"] for h in tr.train(len(batches), log_every=0,
                                                          batches=batches)]
                    ph = tr.step_phases
                    r = {"losses": losses,
                         "steps_s": (len(ph) - TRAIN_WARMUP) / (ph[-1]["t_retired"]
                                                                - ph[TRAIN_WARMUP - 1]["t_retired"]),
                         "launches": {n: getattr(kops, n).launches for n in names}}
                else:
                    r = _phase10_train(tr, kg, batches, tcfg.n_negatives)
                    r["collective_ms"] = _phase10_collective_ms(tr, tcfg.batch_size)
                    # The same run single-device in this process, for its
                    # steps/s and dispatch ms.
                    del tr
                    tr = NGDBTrainer(make_model(family, mcfg, device=dev), kg, tcfg, **sem)
                    r["single"] = _phase10_train(tr, kg, batches, tcfg.n_negatives)
                out[label, pipeline] = r
                del tr
                torch.cuda.empty_cache()
        del table
        # (d) (b)'s checkpoint restored here.
        tr = NGDBTrainer(make_model("betae", pad, device=dev), kg,
                         TrainConfig(checkpoint_dir=ck), ctx=ctx)
        resumed = tr.resume()
        step, arrays, _ = load_checkpoint(ck)
        same = all(np.array_equal(v.cpu().numpy(), arrays[f"params/{k}"])
                   for k, v in tr.params.items())
        same_opt = all(np.array_equal(v.cpu().numpy(), arrays[f"opt/{part}/{k}"])
                       for part in ("m", "v") for k, v in tr.opt_state[part].items())
        out["d"] = {"resumed": resumed, "step": (tr.step, step,
                                                 int(tr.opt_state["step"]),
                                                 int(arrays["opt/step"])),
                    "params": same, "moments": same_opt}
        out["psum"] = _phase10_psum(torch, ctx, world)
    out["counts"] = ctx.mesh.stats()
    with open(os.path.join(work, f"{backend}{world}.r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _phase10_spawn(world: int, backend: str, work: str) -> list:
    """Spawn ``world`` ranks of ``_phase10_rank`` and wait for them (each
    rank's failure, or the time limit, fails the run); their results."""
    import pickle

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    pc = mp.start_processes(_phase10_rank, args=(world, backend, work), nprocs=world,
                            join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while not pc.join(timeout=1):
            if time.monotonic() > deadline:
                fail(f"phase 10: the {world}-rank {backend} spawn ran past "
                     f"{RANK_TIMEOUT_S} s")
    except ProcessException as e:
        fail(f"phase 10: a {backend} rank failed: {e}")
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    out = []
    for r in range(world):
        with open(os.path.join(work, f"{backend}{world}.r{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def phase10(torch, dev, main_path, kg0, batches, tcfg, store, sem_dir, budget, sync_runs,
            pipelined_losses) -> None:
    """Distribution on the card (module docstring, 10). Launches of the
    ranks' training runs are added to ``main_path``."""
    import pickle

    from repro_torch.models import ModelConfig, make_model
    from repro_torch.semantic import SemanticCache
    from repro_torch.training import NGDBTrainer

    t10 = time.perf_counter()
    others = sorted(t.name for t in threading.enumerate() if t is not threading.main_thread())
    leaked = [n for n in others if n.endswith("(_run)") or n.endswith("-batcher")]
    if leaked:
        fail(f"phase 10: threads of earlier phases are still alive: {leaked}")
    print(f"phase 10: threads besides the main one: {others or 'none'}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    atexit.register(shutil.rmtree, work, ignore_errors=True)
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump({"batches": batches, "budget": budget, "sem_dir": sem_dir}, f)
    # Single-device baselines of (b) and (c) on the card: the launcher pads
    # the entity rows to the mesh size, so (b)'s tables draw 14,952 rows,
    # not phase 5's 14,951.
    base = {}
    for label, family, mcfg, hot in (("betae", "betae", ModelConfig(entity_pad=2), False),
                                     ("gqe+H_sem hot set", "gqe",
                                      ModelConfig(semantic_dim=SEM_DIM, entity_pad=2), True)):
        cache = SemanticCache(store, budget, device=dev) if hot else None
        tr = NGDBTrainer(make_model(family, mcfg, device=dev), kg0, tcfg,
                         **({"semantic_cache": cache} if hot else {}))
        path = os.path.join(work, f"step1_{family}.pt")
        r = _phase10_train(tr, kg0, batches[:PHASE10_STEPS], tcfg.n_negatives,
                           timed_to=PHASE10_STEPS - 1,
                           after_first=lambda t: torch.save(_phase10_state(t), path))
        base[label] = (r["losses"], r["steps_s"], tr.model)
        del tr, cache
    torch.cuda.empty_cache()

    # (b), (c), (f), (g): two gloo ranks on the one card.
    t0 = time.perf_counter()
    gloo = _phase10_spawn(2, "gloo", work)
    gloo_s = time.perf_counter() - t0
    added = collections.Counter()
    for label in ("betae", "gqe+H_sem hot set"):
        want_l, base_sps, model = base[label]
        rs = [o[label] for o in gloo]
        if rs[0]["losses"] != rs[1]["losses"]:
            fail(f"phase 10 (b) {label}: the ranks' losses differ: {rs[0]['losses']} "
                 f"{rs[1]['losses']}")
        # What the trainer's update wrote after step 1 (m is 0.1 of the
        # reduced gradient, v 1e-3 of its square) against the single-device
        # step's, on each rank.
        tol = 1e-3 if label == "betae" else 1e-4
        limits = {"m": tol, "v": 2 * tol, "params": 2.001, "rounding": 1.0}
        worst = {}
        for r, o in enumerate(rs):
            for (part, k), g in o["first"].items():
                if not g <= limits[part]:
                    fail(f"phase 10 (b) {label}: after step 1, rank {r}'s {part} of {k} lies "
                         f"{g:.3g} from the single-device step's (gate {limits[part]})")
                worst[part] = max(worst.get(part, (0.0, "")), (g, k))
        gap = max(abs(a - b) for a, b in zip(rs[0]["losses"], want_l))
        if not np.isfinite(rs[0]["losses"]).all() or gap > 1e-3:
            fail(f"phase 10 (b) {label}: losses {rs[0]['losses']} against the single-device "
                 f"run's {want_l} (gap {gap:.3g}, gate 1e-3)")
        half = rs[0]["full_rows"] // 2
        for r, o in enumerate(rs):
            if set(o["local"].values()) != {(half, model.cfg.dim)}:
                fail(f"phase 10 (b) {label}: rank {r} holds {o['local']} of "
                     f"{rs[0]['full_rows']} entity rows")
            if o["launches"] != {k: o["want"].get(k, 0) for k in o["launches"]}:
                fail(f"phase 10 (b) {label}: rank {r} launched {o['launches']}, its plans "
                     f"call for {o['want']}")
            for k, n in o["launches"].items():
                added[k] += n
        if label != "betae" and rs[0]["hot_set"] != rs[1]["hot_set"]:
            fail(f"phase 10 (b) {label}: the ranks' hot sets differ")
        print(f"phase 10 (b) {label} [gloo, 2 ranks on one card, data=2, fsdp]: "
              f"{PHASE10_STEPS} steps, losses within {gap:.3g} of the single-device run "
              f"(gate 1e-3), the ranks bitwise equal; after step 1 the furthest Adam m "
              f"{worst['m'][1]} at {worst['m'][0]:.3g} of its norm (gate {tol}), v "
              f"{worst['v'][1]} at {worst['v'][0]:.3g} (gate {2 * tol}), parameters "
              f"{worst['params'][1]} at {worst['params'][0]:.3g} lr (gate 2.001)"
              + (f", exact-zero gradients {sorted({k for (p, k) in rs[0]['first'] if p == 'rounding'})} "
                 f"at most {worst['rounding'][0]:.3g} of the rounding bound"
                 if "rounding" in worst else "")
              + f"; entity table and moments "
              f"{rs[0]['local']['params']} a rank of {rs[0]['full_rows']} rows; launches "
              f"{[o['launches'] for o in rs]} = the local plans' ops"
              + (" ; hot sets bitwise equal" if label != "betae" else "")
              + f" | steps/s a rank {rs[0]['steps_s']:.3f} (single-device {base_sps:.3f}), "
              f"dispatch ms a step {rs[0]['dispatch_ms']:.3f}, "
              f"collective ms a step {rs[0]['collective_ms']:.3f}, gathered "
              f"{rs[0]['gathered_bytes'] / 1e6:.2f} MB a step a rank | {card}")
    c = [o["c"] for o in gloo]
    want_c = base["betae"][0][:len(c[0]["losses"])]
    gap = max(abs(a - b) for a, b in zip(c[0]["losses"], want_c))
    if (c[0]["losses"] != c[1]["losses"] or gap > 1e-3
            or any(o["local_rows"] != (base["betae"][2].full_shapes["entity"][0] // 2,
                                       ModelConfig().dim) or o["rows"] != tcfg.batch_size
                   for o in c)):
        fail(f"phase 10 (c): {c}")
    for o in c:
        for k, n in o["launches"].items():
            added[k] += n
    print(f"phase 10 (c) betae [gloo, data=1, model=2, 2d]: {len(c[0]['losses'])} steps, "
          f"entity rows {c[0]['local_rows']} a rank, every rank on the whole batch of "
          f"{c[0]['rows']}, losses within {gap:.3g} of the single-device run (gate 1e-3)")
    if not all(o["psum"]["equal"] for o in gloo):
        fail(f"phase 10 (f) gloo: compressed_psum is not its formula: {[o['psum'] for o in gloo]}")
    g = [o["gpipe"] for o in gloo]
    if not all(x["ok"] for x in g):
        fail(f"phase 10 (g): gpipe_forward against the sequential loop: {g}")
    print(f"phase 10 (f) gloo: compressed_psum on 2 ranks bitwise its formula | (g) "
          f"gpipe_forward over pod=2, 8 microbatches: max abs err {g[0]['max_abs_err']:.3g} "
          f"against the sequential loop (gate 1e-5) | gloo host staging: "
          f"{[x['staged'] for x in g]} point-to-point ops a rank in (g) staged through host "
          f"tensors (gloo's send/recv cannot read CUDA memory), "
          f"{[o['staged_b'] for o in gloo]} in (b) | two ranks in {gloo_s:.1f} s")

    # (a), (d), (f): one rank on NCCL.
    t0 = time.perf_counter()
    (nccl,) = _phase10_spawn(1, "nccl", work)
    nccl_s = time.perf_counter() - t0
    for label, want in (("betae", (sync_runs["betae", "pooled"][0], pipelined_losses["betae"])),
                        ("gqe+semantic [resident]",
                         (sync_runs["gqe+semantic [resident]", "pooled"][0],) * 2)):
        for pipeline in (False, True):
            r = nccl[label, pipeline]
            if r["losses"] != want[pipeline]:
                fail(f"phase 10 (a) {label} [{'pipelined' if pipeline else 'sync'}]: losses "
                     f"{r['losses']} are not phase 5's {want[pipeline]} bitwise")
            for k, n in r["launches"].items():
                added[k] += n
        sync = nccl[label, False]
        if sync["launches"] != {k: sync["want"].get(k, 0) for k in sync["launches"]}:
            fail(f"phase 10 (a) {label}: launches {sync['launches']}, plans {sync['want']}")
        base_sps = TRAIN_STEPS / sync_runs[label, "pooled"][1]
        one = sync["single"]
        print(f"phase 10 (a) {label} [NCCL, world 1, data=1, fsdp]: sync and pipelined "
              f"{len(sync['losses'])} losses bitwise phase 5's and 5c's | steps/s sync "
              f"{sync['steps_s']:.3f}, pipelined {nccl[label, True]['steps_s']:.3f} against "
              f"phase 5's single-device {base_sps:.3f} and {one['steps_s']:.3f} single-device "
              f"in the rank's process; dispatch ms a step {sync['dispatch_ms']:.3f} "
              f"(single-device {one['dispatch_ms']:.3f}); collective ms a step "
              f"{sync['collective_ms']:.3f}, gathered {sync['gathered_bytes'] / 1e6:.2f} MB "
              f"a step | {card}")
    d = nccl["d"]
    if not (d["resumed"] and len(set(d["step"])) == 1 and d["step"][0] == PHASE10_STEPS
            and d["params"] and d["moments"]):
        fail(f"phase 10 (d): (b)'s checkpoint restored at world 1: {d}")
    if not nccl["psum"]["equal"]:
        fail(f"phase 10 (f) nccl: compressed_psum is not its formula: {nccl['psum']}")
    print(f"phase 10 (d): (b)'s 2-rank checkpoint (step {d['step'][0]}) restored on NCCL at "
          f"world 1: parameters, moments and step bitwise | (f) nccl: compressed_psum bitwise "
          f"its formula | NCCL staged {nccl['counts']['staged']} | one rank in {nccl_s:.1f} s")

    # (e) The training CLI under torchrun.
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "1", "-m", "repro_torch.launch.train", "--mesh", "data=1", "--profile", "fsdp",
            "--model", "betae", "--dim", str(ModelConfig().dim), "--steps", "3",
            "--batch-size", str(tcfg.batch_size), "--negatives", str(tcfg.n_negatives),
            "--lr", str(tcfg.adam.lr), "--eval-queries", "64", "--log-every", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=RANK_TIMEOUT_S,
                          cwd=work, env={**os.environ, "PYTHONPATH": str(SRC)})
    lines = proc.stdout.splitlines()
    if (proc.returncode != 0
            or "execution context: mesh(data=1, model=1) profile=fsdp (1 devices, dp=1)"
            not in lines or sum(l.startswith("step ") for l in lines) != 3
            or not any(l.startswith("eval: ") for l in lines)):
        fail(f"phase 10 (e): torchrun rc {proc.returncode}\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    print(f"phase 10 (e): {' '.join(argv[1:])} ({time.perf_counter() - t0:.1f} s)")
    for line in lines:
        if line.startswith(("execution context", "entity table", "step ", "trained", "eval")):
            print(f"  | {line[:300]}")

    for name, key in (("intersect", "intersect[training]"),
                      ("intersect_backward", "intersect_backward"),
                      ("gather_fuse", "gather_fuse[training]"),
                      ("gather_fuse_backward", "gather_fuse_backward")):
        if added[name]:
            n, counter = main_path[key]
            main_path[key] = (n + added[name], counter)
    print(f"distribution: launches {dict(added)} of the ranks added to the kernels line | "
          f"phase 10 in {time.perf_counter() - t10:.1f} s")


# ------------------------------------------------ 11. serving under a mesh
PHASE11_REQUESTS = 128     # requests a family: a warm-up pass, then the timed pass
PHASE11_REPLAYED = 4       # batches a family whose raw scores are held to single-device
PHASE11_FAMILIES = (("betae", "betae", False), ("gqe", "gqe", False),
                    ("gqe+H_sem hot set", "gqe", True))


def _phase11_expected(executor, model, log, rows: int, lo: int, hot: bool) -> dict:
    """The kernels one rank's plans call for over ``log``'s batches: one
    ``intersect`` an intersection or union pool (BetaE's), one ``gather_fuse``
    an EMBED pool (H_sem through the hot set), and the scoring: one
    ``scoring`` a batch (GQE), or one ``gather_fuse`` and one ``scoring`` a
    chunk of this rank's real rows (out of core)."""
    from repro_torch.core import OpType

    want = collections.Counter()
    n_real = model.n_entities
    chunks = -(-max(0, min(lo + rows, n_real) - lo) // CHUNK)
    for rec in log:
        for op, _card, _pn in executor.prepare(rec.queries).meta:
            if op in (int(OpType.INTERSECT), int(OpType.UNION)) and model.name == "betae":
                want["intersect"] += 1   # GQE's intersection is an MLP: no kernel
            elif op == int(OpType.EMBED) and hot:
                want["gather_fuse"] += 1
        if model.score_mode:
            want["scoring"] += chunks if hot else 1
            if hot:
                want["gather_fuse"] += chunks
    return dict(want)


def _phase11_rank(rank: int, world: int, backend: str, work: str) -> None:
    """One rank of phase 11 (spawned): two gloo ranks sharing the card, or
    one NCCL rank. Serves each family under each mesh through the engine
    (rank 0 submits, the other rank follows), and ``--replicas 2`` for BetaE
    and GQE; pickles what it saw to ``work/p11_<backend>.r<rank>.pkl``."""
    import datetime
    import hashlib
    import pickle

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    dev = torch.device(inp["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    dist.init_process_group(backend, init_method=f"file://{work}/pg11_{backend}{world}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    from repro_torch.core import PooledExecutor
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.distributed import make_execution_context
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.semantic import SemanticCache, SemanticStore
    from repro_torch.serving import (ReplicaPool, Router, ServingConfig, ServingEngine,
                                     make_workload, run_closed_loop, scorer_for)

    kg = generate_synthetic_kg(*FB15K, seed=0, name="FB15k-shaped")
    store = SemanticStore(inp["sem_dir"])
    queries = make_workload(kg, PHASE11_REQUESTS, seed=7)
    scfg = ServingConfig(max_batch=16, top_k=TOP_K, record_batches=True)
    meshes = ((("data=1", "fsdp"),) if world == 1
              else (("data=2", "fsdp"), ("data=1,model=2", "2d")))

    def build(family, hot, ctx):
        mcfg = ModelConfig(semantic_dim=SEM_DIM if hot else 0, entity_pad=2)
        model = make_model(family, mcfg, device=dev)
        cache = SemanticCache(store, SEM_BUDGET, device=dev, ctx=ctx) if hot else None
        params = model.init_params(torch.Generator(device=dev).manual_seed(1), *FB15K[:2],
                                   semantic_cache=cache, ctx=ctx)
        return model, params, cache

    def counts():
        return {"scoring": kops.scoring.launches, "intersect": kops.intersect.launches,
                "gather_fuse": kops.gather_fuse.launches}

    def zero():
        kops.scoring.launches = kops.intersect.launches = kops.gather_fuse.launches = 0

    def answers(results):
        """A result's answer: what serve_batch returns (rank 0's engine also
        notes each request's latency and batch size in it)."""
        return [{k: r[k] for k in ("pattern", "anchors", "relations", "top_entities",
                                   "scores")} for r in results]

    def digest(log):
        rows = [[q.key() for q in rec.queries] + answers(rec.results) for rec in log]
        return hashlib.sha256(json.dumps(rows, default=str).encode()).hexdigest()

    def raw(model, params, ex, comp, cache, ctx):
        """serve_batch's scores of one composition, unrounded."""
        if cache is not None:
            stage = cache.plan(np.concatenate([q.anchors for q in comp]))
            if stage is not None:
                cache.apply_to(params, stage)
        scorer = scorer_for(model, ctx)
        view = enc = params
        if ctx is not None:
            view = scorer.mesh.view(params)
            enc = scorer.mesh.encode_params(view, comp)
        with torch.no_grad():
            states = ex.encode(enc, comp)
            if cache is not None:
                return scorer.chunked(view, states, store.read_rows)
            return scorer(view, states).cpu().numpy()

    out = {"single": {}}
    for spec, profile in meshes:
        ctx = make_execution_context(spec, profile=profile, device=dev, backend=backend)
        for label, family, hot in PHASE11_FAMILIES:
            model, params, cache = build(family, hot, ctx)
            ex = PooledExecutor(model, b_max=256, device=dev, ctx=ctx)
            zero()
            eng = ServingEngine(model, params, executor=ex, cfg=scfg, device=dev,
                                sem_cache=cache, sem_rows_fn=store.read_rows if hot else None,
                                ctx=ctx)
            r = {}
            if eng.leader:
                run_closed_loop(eng, queries, concurrency=32)
                eng.reset_counters(clear_log=False)
                rep = run_closed_loop(eng, queries, concurrency=32)
                r.update(qps=rep.qps, p99=rep.latency_ms["p99"], retraces=eng.retraces())
                eng.close()
            else:
                eng.follow()
                eng.close()
            sync()
            r["launches"] = counts()
            log = list(eng.batch_log)
            lo = ctx.mesh.index(scorer_for(model, ctx).mesh.axes) * params["entity"].shape[0]
            r["want"] = _phase11_expected(ex, model, log, params["entity"].shape[0], lo, hot)
            r["digest"], r["batches"] = digest(log), len(log)
            r["local"] = tuple(params["entity"].shape)
            r["full"] = tuple(model.full_shapes["entity"])
            # The engine's answers are serve_batch's on its compositions (mesh,
            # collective), and the single-device serve_batch's bitwise at one
            # rank, within the tolerance and top-k gap rule at two.
            replay = [serve_batch(model, params, ex, rec.queries, top_k=TOP_K, device=dev,
                                  sem_cache=cache, ctx=ctx,
                                  sem_rows_fn=store.read_rows if hot else None)[0][:rec.n_real]
                      for rec in log]
            r["replay_equal"] = replay == [answers(rec.results[:rec.n_real]) for rec in log]
            smodel, sparams, scache = build(family, hot, None)
            sex = PooledExecutor(smodel, b_max=256, device=dev)
            single = [serve_batch(smodel, sparams, sex, rec.queries, top_k=TOP_K, device=dev,
                                  sem_cache=scache,
                                  sem_rows_fn=store.read_rows if hot else None)[0][:rec.n_real]
                      for rec in log]
            r["single_equal"] = single == [answers(rec.results[:rec.n_real]) for rec in log]
            gaps, topk_ok = [], True
            tol = 1e-4 * ModelConfig().dim
            for rec, want in zip(log[:PHASE11_REPLAYED], single):
                got_s = raw(model, params, ex, rec.queries, cache, ctx)
                want_s = raw(smodel, sparams, sex, rec.queries, scache, None)
                gaps.append(float(np.max(np.abs(got_s - want_s)
                                         / (tol + 1e-4 * np.abs(want_s)))))
                for i, res in enumerate(rec.results[:rec.n_real]):
                    srt = np.sort(want_s[i])[::-1]
                    for j in range(TOP_K):
                        if (srt[j] - srt[j + 1] > tol + 1e-4 * abs(srt[j])
                                and set(res["top_entities"][:j + 1])
                                != set(want[i]["top_entities"][:j + 1])):
                            topk_ok = False
            r["gap"], r["topk_ok"] = max(gaps), topk_ok
            if rank == 0 and world == 1:
                # Single-device QPS and p99 on the same traffic, for beside.
                seng = ServingEngine(smodel, sparams, executor=sex, cfg=scfg, device=dev,
                                     sem_cache=scache,
                                     sem_rows_fn=store.read_rows if hot else None)
                with seng:
                    run_closed_loop(seng, queries, concurrency=32)
                    srep = run_closed_loop(seng, queries, concurrency=32)
                out["single"][label] = (srep.qps, srep.latency_ms["p99"])
            out[spec, profile, label] = r
            del eng, model, params, cache, smodel, sparams, scache
            torch.cuda.empty_cache()
        for label in ("betae", "gqe"):
            model, params, _ = build(label, False, ctx)
            zero()
            pool = ReplicaPool(model, params, n_replicas=2, cfg=scfg, b_max=256, device=dev,
                               ctx=ctx)
            if ctx.rank == 0:
                router = Router(pool)
                for f in router.submit_many(queries):
                    f.result(timeout=RANK_TIMEOUT_S)
                router.close()
            else:
                pool.follow()
                pool.close()
            sync()
            t = {"launches": counts(), "want": collections.Counter()}
            lo = ctx.mesh.index(scorer_for(model, ctx).mesh.axes) * params["entity"].shape[0]
            logs = {rid: list(rep.engine.batch_log) for rid, rep in pool.replicas().items()}
            for rid, log in logs.items():
                t["want"].update(_phase11_expected(pool.replicas()[rid].executor, model, log,
                                                   params["entity"].shape[0], lo, False))
                t["replay_equal", rid] = [
                    serve_batch(model, params, pool.replicas()[rid].executor, rec.queries,
                                top_k=TOP_K, device=dev, ctx=ctx)[0][:rec.n_real]
                    for rec in log] == [answers(rec.results[:rec.n_real]) for rec in log]
            t["want"] = dict(t["want"])
            t["digest"] = {rid: digest(log) for rid, log in logs.items()}
            t["batches"] = {rid: len(log) for rid, log in logs.items()}
            out[spec, profile, label, "replicas"] = t
            del pool, model, params
            torch.cuda.empty_cache()
        out["counts", spec, profile] = ctx.mesh.stats()
    with open(os.path.join(work, f"p11_{backend}{world}.r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _phase11_spawn(world: int, backend: str, work: str) -> list:
    import pickle

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    pc = mp.start_processes(_phase11_rank, args=(world, backend, work), nprocs=world,
                            join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while not pc.join(timeout=1):
            if time.monotonic() > deadline:
                fail(f"phase 11: the {world}-rank {backend} spawn ran past {RANK_TIMEOUT_S} s")
    except ProcessException as e:
        fail(f"phase 11: a {backend} rank failed: {e}")
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    out = []
    for r in range(world):
        with open(os.path.join(work, f"p11_{backend}{world}.r{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def phase11(main_path, sem_dir, card) -> None:
    """Serving under a mesh on the card (module docstring, 11). Launches of
    the ranks' engines are added to ``main_path``."""
    import pickle

    t11 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_serving_")
    atexit.register(shutil.rmtree, work, ignore_errors=True)
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump({"sem_dir": sem_dir, "device": "cuda:0"}, f)
    added = collections.Counter()
    keys = {"betae": {"intersect": "intersect"}, "gqe": {"scoring": "scoring[l1]"},
            "gqe+H_sem hot set": {"scoring": "scoring[l1][out-of-core]",
                                  "gather_fuse": "gather_fuse[out-of-core]"}}
    for world, backend in ((1, "nccl"), (2, "gloo")):
        t0 = time.perf_counter()
        ranks = _phase11_spawn(world, backend, work)
        took = time.perf_counter() - t0
        meshes = [k[:2] for k in ranks[0] if len(k) == 3 and k[2] == "gqe"]
        for spec, profile in meshes:
            where = f"[{backend}, {world} rank{'s' if world > 1 else ''}, {spec}, {profile}]"
            for label, _family, _hot in PHASE11_FAMILIES:
                rs = [o[spec, profile, label] for o in ranks]
                for r, o in enumerate(rs):
                    if o["launches"] != {k: o["want"].get(k, 0) for k in o["launches"]}:
                        fail(f"phase 11 {label} {where}: rank {r} launched {o['launches']}, "
                             f"its plans call for {o['want']}")
                    if not o["replay_equal"]:
                        fail(f"phase 11 {label} {where}: rank {r}'s engine answers are not "
                             f"serve_batch's on its compositions")
                    if world > 1 and o["local"][0] * 2 != o["full"][0]:
                        fail(f"phase 11 {label} {where}: rank {r} holds {o['local']} of "
                             f"{o['full']} entity rows")
                    for k, n in o["launches"].items():
                        if k in keys[label]:
                            added[keys[label][k]] += n
                if len({o["digest"] for o in rs}) != 1 or rs[0]["batches"] == 0:
                    fail(f"phase 11 {label} {where}: the ranks' answers differ")
                if world == 1 and not (rs[0]["single_equal"] and rs[0]["gap"] == 0.0):
                    fail(f"phase 11 {label} {where}: not bitwise the single-device engine "
                         f"(answers equal {rs[0]['single_equal']}, scores "
                         f"{rs[0]['gap']:.3g} of the tolerance)")
                if not (rs[0]["gap"] <= 1.0 and rs[0]["topk_ok"]):
                    fail(f"phase 11 {label} {where}: raw scores at {rs[0]['gap']:.3g} of the "
                         f"tolerance (rtol 1e-4, atol 1e-4 d), top-k by the gap rule "
                         f"{rs[0]['topk_ok']}")
                one = ranks[0]["single"].get(label)
                vs = ("bitwise the single-device engine" if world == 1 else
                      f"raw scores within {rs[0]['gap']:.3g} of the tolerance of "
                      f"single-device's, top-k equal by the gap rule")
                print(f"phase 11 {label} {where}: {rs[0]['batches']} micro-batches, answers "
                      f"bitwise equal on every rank and to serve_batch on the engine's "
                      f"compositions; {vs}; entity rows {rs[0]['local']} a rank of {rs[0]['full']}; launches "
                      f"{[o['launches'] for o in rs]} = the plans' ops | timed pass "
                      f"{rs[0]['qps']:.1f} q/s, p99 {rs[0]['p99']:.2f} ms, {rs[0]['retraces']} "
                      f"retraces"
                      + (f" (single-device {one[0]:.1f} q/s, p99 {one[1]:.2f} ms)" if one else "")
                      + f" | {card}")
            for label in ("betae", "gqe"):
                ts = [o[spec, profile, label, "replicas"] for o in ranks]
                for r, t in enumerate(ts):
                    if t["launches"] != {k: t["want"].get(k, 0) for k in t["launches"]}:
                        fail(f"phase 11 {label} --replicas 2 {where}: rank {r} launched "
                             f"{t['launches']}, its plans call for {t['want']}")
                    if not all(v for k, v in t.items() if isinstance(k, tuple)):
                        fail(f"phase 11 {label} --replicas 2 {where}: a replica's answers are "
                             f"not serve_batch's on its compositions")
                    for k, n in t["launches"].items():
                        if k in keys[label]:
                            added[keys[label][k]] += n
                if len({json.dumps(t["digest"], sort_keys=True) for t in ts}) != 1:
                    fail(f"phase 11 {label} --replicas 2 {where}: the ranks' answers differ")
                print(f"phase 11 {label} --replicas 2 {where}: micro-batches a replica "
                      f"{ts[0]['batches']}, answers bitwise equal on every rank and to "
                      f"serve_batch; launches {[t['launches'] for t in ts]} = the plans' ops")
            c = ranks[0]["counts", spec, profile]
            print(f"phase 11 {where}: collectives of rank 0 {c['counts']}, "
                  f"{sum(c['bytes'].values()) / 1e6:.2f} MB, staged {c['staged']} | "
                  f"{world} rank{'s' if world > 1 else ''} in {took:.1f} s")
    # The serving CLI under torchrun, on the card.
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "1", "-m", "repro_torch.launch.serve", "--mesh", "data=1", "--profile", "fsdp",
            "--model", "gqe", "--requests", "64", "--top-k", str(TOP_K)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=RANK_TIMEOUT_S,
                          cwd=work, env={**os.environ, "PYTHONPATH": str(SRC)})
    lines = proc.stdout.splitlines()
    if (proc.returncode != 0
            or "execution context: mesh(data=1, model=1) profile=fsdp (1 devices, dp=1)"
            not in lines or not any("0 steady-state retraces" in l for l in lines)
            or not any(l.startswith("first: ") for l in lines)):
        fail(f"phase 11 CLI: torchrun rc {proc.returncode}\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    print(f"phase 11 CLI: {' '.join(argv[1:])} ({time.perf_counter() - t0:.1f} s)")
    for line in lines:
        if line.startswith(("execution context", "entity table", "[closed]", "engine:")):
            print(f"  | {line[:300]}")
    for key, n in added.items():
        k_n, counter = main_path[key]
        main_path[key] = (k_n + n, counter)
    print(f"serving under a mesh: launches {dict(added)} of the ranks added to the kernels "
          f"line | phase 11 in {time.perf_counter() - t11:.1f} s")


# ------------------------------------------------------------ 12. the LM zoo
PHASE12_SEQ = 1024         # prefill and training tokens a sequence (batch 1)
PHASE12_DECODE = 16        # decode steps after the prefill
PHASE12_TRAIN_STEPS = 3
# fp32 step-1 Adam m of a leaf, card against CPU, norm-wise: the two differ
# by summation order only (a negated gradient is 2 off, a zero one 1).
PHASE12_MOMENT_TOL = 1e-3
PHASE12_TRAIN_BYTES = 60e9   # train only where params, grads and both moments fit this
# Full published width; depth cut where the fp32 masters would not fit the card.
PHASE12_FULL = (("qwen2-0.5b", None), ("mamba2-1.3b", None), ("whisper-large-v3", None),
                ("mixtral-8x22b", 4), ("jamba-v0.1-52b", 8))


def _phase12_batch(torch, cfg, b: int, s: int, dev, seed: int = 0) -> dict:
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {"labels": torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)}
    if cfg.frontend == "vision":
        batch["embeddings"] = (torch.randn((b, s, cfg.d_model), generator=g, device=dev)
                               * 0.05).to(torch.bfloat16)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    if cfg.is_encdec:
        batch["encoder_frames"] = (torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g,
                                               device=dev) * 0.05).to(torch.bfloat16)
    return batch


def _phase12_prefill_decode(torch, cfg, dev) -> float:
    """Decode of input 32 after prefill of 32 inputs against forward's logits
    at 32 (bf16, the reference's rtol 5e-2, atol 5e-1), on the card: minus
    the largest difference where it holds, the largest excess over the
    tolerance where it does not. MoE archs get an ample capacity, as the
    reference's test gives them; whisper's prefill and forward see the same
    encoder frames; llava's prefix is embeddings, its input 32 the embedding
    of the token decode is given."""
    import dataclasses

    from repro_torch.lm.model import forward, init_params, logits_fn
    from repro_torch.lm.steps import make_decode_step, make_prefill_step

    s = 32
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    params = init_params(cfg, seed=1, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, s + 1), device=dev, generator=g)
    kw, prefix = {"tokens": toks}, {"tokens": toks[:, :s]}
    if cfg.frontend == "vision":
        emb = torch.randn((2, s + 1, cfg.d_model), generator=g, device=dev) * 0.05
        emb[:, s] = params["embed"][toks[:, s]]
        kw, prefix = {"embeddings": emb}, {"embeddings": emb[:, :s]}
    if cfg.is_encdec:
        frames = (torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=g, device=dev)
                  * 0.05).to(torch.bfloat16)
        kw["enc_frames"] = prefix["encoder_frames"] = frames
    with torch.no_grad():
        ref = logits_fn(params, cfg, forward(params, cfg, **kw)[0][:, -1:]).float()
    caches, _ = make_prefill_step(cfg, cache_margin=8)(params, prefix)
    got = make_decode_step(cfg)(params, caches, toks[:, s:], s)[0].float()
    diff = (got - ref).abs()
    excess = float((diff - (5e-1 + 5e-2 * ref.abs())).max())
    return excess if excess > 0 else -float(diff.max())


def phase12(torch, dev, card) -> None:
    """The LM zoo on the card (module docstring, 12)."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.lm import model as lm_model
    from repro_torch.lm.model import (abstract_params, forward, init_params, logits_fn,
                                      param_bytes)
    from repro_torch.lm.steps import (flatten, lm_adam_init, make_decode_step,
                                      make_prefill_step, make_train_step)

    t12 = time.perf_counter()

    def to(tree, device):
        return {k: to(v, device) if isinstance(v, dict) else v.to(device, copy=True)
                for k, v in tree.items()}

    # (a) The ten reduced configurations: the card against the CPU path.
    for name in sorted(ARCHS):
        cfg = reduced_config(ARCHS[name])
        host = init_params(cfg, seed=0, device="cpu")
        batch = _phase12_batch(torch, cfg, 2, 32, torch.device("cpu"))
        gb = to(batch, dev)
        # fp32 compute (TF32 off): the card's forward logits against the CPU's.
        saved = lm_model.COMPUTE_DTYPE
        lm_model.COMPUTE_DTYPE = torch.float32
        try:
            with torch.no_grad():
                fb = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
                kw = {k: fb[k] for k in ("tokens", "embeddings") if k in fb}
                if cfg.is_encdec:
                    kw["enc_frames"] = fb["encoder_frames"]
                want = logits_fn(host, cfg, forward(host, cfg, **kw)[0])
                gp = to(host, dev)
                got = logits_fn(gp, cfg, forward(gp, cfg, **to(kw, dev))[0]).cpu()
            # One train step each: step 1's Adam m = (1-b1)·g, leaf by leaf.
            hm = lm_adam_init(host)
            make_train_step(cfg)(host, hm, fb)
            gm = lm_adam_init(gp)
            make_train_step(cfg)(gp, gm, to(fb, dev))
        finally:
            lm_model.COMPUTE_DTYPE = saved
        f32_err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            fail(f"phase 12 (a) {name}: fp32 logits on the card {f32_err:.3g} from the CPU's "
                 f"(gate rtol 1e-4, atol 1e-4)")
        m_gaps = {k: float(torch.linalg.vector_norm(gm["m"][k].cpu() - m) /
                           max(float(torch.linalg.vector_norm(m)), 1e-30))
                  for k, m in hm["m"].items()}
        m_leaf = max(m_gaps, key=m_gaps.get)
        if m_gaps[m_leaf] > PHASE12_MOMENT_TOL:
            fail(f"phase 12 (a) {name}: fp32 step-1 Adam m of {m_leaf} on the card "
                 f"{m_gaps[m_leaf]:.3g} of its norm from the CPU's (gate {PHASE12_MOMENT_TOL})")
        # bf16, the default: one train step, prefill, decode.
        hp = init_params(cfg, seed=0, device="cpu")
        _, _, want_loss = make_train_step(cfg)(hp, lm_adam_init(hp), batch)
        gp = to(init_params(cfg, seed=0, device="cpu"), dev)
        before = gp["embed"].clone()
        _, _, loss = make_train_step(cfg)(gp, lm_adam_init(gp), gb)
        moved = float((gp["embed"] - before).abs().max())
        caches, pl = make_prefill_step(cfg, cache_margin=8)(gp, gb)
        dl, _ = make_decode_step(cfg)(gp, caches, torch.zeros((2, 1), dtype=torch.long,
                                                              device=dev), 32)
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (loss, pl, dl))
        if not finite or abs(float(loss) - float(want_loss)) > 5e-2 or not (
                moved > 0 or cfg.frontend == "vision"):
            fail(f"phase 12 (a) {name}: loss {float(loss)} (CPU {float(want_loss)}, gate 5e-2), "
                 f"finite {finite}, embed moved {moved}")
        # The reference's invariant: decode after prefill = forward.
        err = _phase12_prefill_decode(torch, cfg, dev)
        if err > 0:
            fail(f"phase 12 (a) {name}: prefill + decode {err:.3g} past forward's "
                 f"(gate rtol 5e-2, atol 5e-1)")
        note = f"; prefill + decode within {-err:.3g} of forward (rtol 5e-2, atol 5e-1)"
        print(f"phase 12 (a) {name}: fp32 logits {f32_err:.3g} from the CPU path's (gate "
              f"1e-4), step-1 Adam m at most {m_gaps[m_leaf]:.3g} of a leaf's norm ({m_leaf}; "
              f"gate {PHASE12_MOMENT_TOL}); bf16 train step loss {float(loss):.5f} (CPU {float(want_loss):.5f}), "
              f"prefill and decode logits finite{note}")
        del gp, caches
    torch.cuda.empty_cache()

    # (b) Full published width.
    for name, depth in PHASE12_FULL:
        cfg = ARCHS[name]
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        nbytes = param_bytes(abstract_params(cfg))
        train = 4 * nbytes <= PHASE12_TRAIN_BYTES
        cut = (f"depth cut to {depth} of {ARCHS[name].n_layers} layers" if depth is not None
               else f"all {cfg.n_layers} layers")
        print(f"phase 12 (b) {name}: {cut}; reckoned {nbytes / 1e9:.2f} GB of fp32 parameters"
              + (f", {4 * nbytes / 1e9:.2f} GB with gradients and both Adam moments: trains"
                 if train else f" ({4 * nbytes / 1e9:.2f} GB to train, over "
                 f"{PHASE12_TRAIN_BYTES / 1e9:.0f} GB: prefill and decode only)"))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batch = _phase12_batch(torch, cfg, 1, PHASE12_SEQ, dev)
        line = [f"init {init_s:.1f} s"]
        if train:
            opt = lm_adam_init(params)
            step = make_train_step(cfg)
            losses = []
            t0 = time.perf_counter()
            for _ in range(PHASE12_TRAIN_STEPS):
                _, _, loss = step(params, opt, batch)
                losses.append(float(loss))
            train_s = time.perf_counter() - t0
            if not np.isfinite(losses).all():
                fail(f"phase 12 (b) {name}: train losses {losses}")
            line.append(f"{PHASE12_TRAIN_STEPS} train steps of {PHASE12_SEQ} tokens: losses "
                        f"{[round(x, 4) for x in losses]}, "
                        f"{PHASE12_TRAIN_STEPS * PHASE12_SEQ / train_s:.0f} tokens/s")
            del opt, step
            torch.cuda.empty_cache()
        prefill = make_prefill_step(cfg, cache_margin=PHASE12_DECODE)
        decode = make_decode_step(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches, logits = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        tok = logits[:, -1:].float().argmax(-1)
        outs = [logits]
        t0 = time.perf_counter()
        for i in range(PHASE12_DECODE):
            logits, caches = decode(params, caches, tok, PHASE12_SEQ + i)
            tok = logits[:, -1:].float().argmax(-1)
            outs.append(logits)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        if not all(bool(torch.isfinite(o.float()).all()) and o.shape[-1] == cfg.padded_vocab()
                   for o in outs):
            fail(f"phase 12 (b) {name}: prefill/decode logits not finite or misshapen")
        line.append(f"prefill of {PHASE12_SEQ} tokens {PHASE12_SEQ / prefill_s:.0f} tokens/s "
                    f"({prefill_s * 1e3:.1f} ms), {PHASE12_DECODE} decode steps "
                    f"{PHASE12_DECODE / decode_s:.1f} tokens/s, logits finite")
        peak = torch.cuda.max_memory_allocated()
        print(f"phase 12 (b) {name} ({cut}): {'; '.join(line)} | peak "
              f"torch.cuda.max_memory_allocated {peak / 1e9:.2f} GB | {card}")
        del params, caches, logits, outs, batch
        torch.cuda.empty_cache()
    print(f"LM zoo: phase 12 in {time.perf_counter() - t12:.1f} s")


# ------------------------------------------------- 13. the LM zoo over a mesh
PHASE13_NCCL = (("qwen2-0.5b", None), ("mixtral-8x22b", 4))   # phase 12's sizes
PHASE13_MESHES = (("data=1,model=2", "2d", 1), ("data=2", "fsdp", 2))  # gloo pairs
# (b): the single-device dry run against the card at phase 12 (b)'s sizes.
PHASE13_DRY = (("qwen2-0.5b", None, "train"), ("mamba2-1.3b", None, "train"),
               ("whisper-large-v3", None, "train"), ("mixtral-8x22b", 4, "prefill"))
# Dry-run peak against the step's own max_memory_allocated: sound runs read
# 0.00-0.54%, a planted 12% undercount of the tracker 1.35-5.72% (PERF.md).
PHASE13_PEAK_TOL = 0.01
# (c) always runs this subset: every architecture and every shape at least
# once, cheap cells first (the full sweep takes over 180 s; PERF.md).
PHASE13_SUBSET = (("qwen2-0.5b", "train_4k"), ("jamba-v0.1-52b", "prefill_32k"),
                  ("mamba2-1.3b", "long_500k"), ("qwen2-72b", "decode_32k"),
                  ("qwen3-4b", "decode_32k"), ("internlm2-20b", "decode_32k"),
                  ("whisper-large-v3", "decode_32k"), ("llava-next-34b", "decode_32k"),
                  ("grok-1-314b", "decode_32k"), ("mixtral-8x22b", "decode_32k"))


def _phase13_program(torch, cfg, ctx, dp, full, batch, b):
    """Forward logits, prefill and decode logits, then one train step on
    this rank's shards of ``full``: the outputs, the shards and Adam m."""
    from repro_torch.lm.model import forward, logits_fn
    from repro_torch.lm.parallel import MeshPlan
    from repro_torch.lm.steps import (_forward_kwargs, lm_adam_init, make_decode_step,
                                      make_prefill_step, make_train_step)

    mesh = ctx.mesh
    shards = ctx.shard_tree(full)
    plan = MeshPlan(cfg, mesh, dp, b)
    local = {k: plan.local_rows(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = logits_fn(shards, cfg, forward(shards, cfg, par=plan,
                                                **_forward_kwargs(cfg, local))[0], par=plan)
    caches, prefill = make_prefill_step(cfg, mesh, dp, cache_margin=8)(shards, batch)
    tok = torch.zeros((b, 1), dtype=torch.long, device=batch["labels"].device)
    decode, _ = make_decode_step(cfg, mesh, dp)(shards, caches, tok, 32)
    opt = lm_adam_init(shards)
    _, opt, loss = make_train_step(cfg, mesh, dp)(shards, opt, batch)
    return {"logits": logits, "prefill": prefill, "decode": decode, "loss": loss,
            "m": opt["m"]}


def _phase13_gloo(torch, dev, rank: int, out: dict) -> None:
    """(a) on two gloo ranks sharing the card: each reduced architecture in
    fp32 compute, each rank against single-device steps on its rows, and
    its counters against a virtual mesh's over the same program on meta."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.distributed import ExecutionContext, VirtualMesh, make_execution_context
    from repro_torch.distributed.sharding import dp_axes
    from repro_torch.lm import model as lm_model
    from repro_torch.lm.model import forward, init_params, logits_fn
    from repro_torch.lm.steps import (_forward_kwargs, flatten, lm_adam_init, make_decode_step,
                                      make_prefill_step, make_train_step)

    lm_model.COMPUTE_DTYPE = torch.float32
    for spec, profile, b in PHASE13_MESHES:
        live = make_execution_context(spec, profile=profile, device=dev, backend="gloo")
        dp = dp_axes(live.mesh, profile)
        rows = [0] if b == 1 else [live.mesh.index(dp)]
        for name in sorted(ARCHS):
            modes = ("tp", "ep") if name in ("mixtral-8x22b", "jamba-v0.1-52b") else ("tp",)
            for mode in modes:
                for seq in ((False, True) if profile == "2d" else (False,)):
                    cfg = dataclasses.replace(reduced_config(ARCHS[name]), moe_mode=mode,
                                              seq_shard=seq)
                    ctx = ExecutionContext.from_mesh(live.mesh, profile=profile, moe_mode=mode)
                    full = init_params(cfg, seed=0, device=dev)
                    batch = {k: (v.float() if v.is_floating_point() else v)[:b].to(dev)
                             for k, v in _phase12_batch(torch, cfg, 2, 32,
                                                        torch.device("cpu")).items()}
                    live.mesh.counts.clear()
                    live.mesh.bytes.clear()
                    got = _phase13_program(torch, cfg, ctx, dp, full, batch, b)
                    counts = live.mesh.stats()
                    vm = VirtualMesh(dict(live.mesh.shape), rank)
                    _phase13_program(torch, cfg,
                                     ExecutionContext.from_mesh(vm, profile=profile,
                                                                moe_mode=mode), dp,
                                     init_params(cfg, device="meta"),
                                     {k: v.to("meta") for k, v in batch.items()}, b)
                    # Single-device steps: this rank's row, and every row's Adam m
                    # (step 1's m is linear in the gradient: the batch's is the mean).
                    want, ms, losses = {}, [], []
                    for r in range(b):
                        row = {k: v[r:r + 1] for k, v in batch.items()}
                        p = init_params(cfg, seed=0, device=dev)
                        if r in rows:
                            with torch.no_grad():
                                want["logits"] = logits_fn(p, cfg, forward(
                                    p, cfg, **_forward_kwargs(cfg, row))[0])
                            caches, want["prefill"] = make_prefill_step(cfg, cache_margin=8)(
                                p, row)
                            want["decode"], _ = make_decode_step(cfg)(
                                p, caches, torch.zeros((1, 1), dtype=torch.long, device=dev), 32)
                        opt = lm_adam_init(p)
                        _, opt, loss = make_train_step(cfg)(p, opt, row)
                        ms.append(flatten(opt["m"]))
                        losses.append(float(loss))
                    shapes = {k: tuple(v.shape) for k, v in flatten(full).items()}
                    m_gap = 0.0
                    for k, v in flatten(got["m"]).items():
                        whole = ctx.gather(k.rsplit("/", 1)[-1], v, shapes[k])
                        ref = sum(m[k] for m in ms) / b
                        m_gap = max(m_gap, float(torch.linalg.vector_norm(whole - ref)
                                                 / max(float(torch.linalg.vector_norm(ref)),
                                                       1e-30)))
                    out[spec, profile, name, mode, seq] = {
                        "logits": max(float(((got[k] - want[k]).abs()
                                             - 1e-4 * want[k].abs()).max())
                                      for k in ("logits", "prefill", "decode")),
                        "loss": abs(float(got["loss"]) - sum(losses) / b),
                        "m": m_gap, "counts": counts, "virtual": vm.stats()}
    lm_model.COMPUTE_DTYPE = torch.bfloat16


def _phase13_nccl(torch, dev, out: dict) -> None:
    """(a) on one NCCL rank: qwen2-0.5b and mixtral-8x22b (depth 4) at phase
    12 (b)'s sizes, train (qwen2-0.5b), prefill and decode under ``data=1``
    2d and fsdp, against single-device steps on the same parameters:
    bitwise. One rank's shards are its whole tensors."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.distributed import make_execution_context
    from repro_torch.distributed.sharding import dp_axes
    from repro_torch.lm.model import abstract_params, init_params, param_bytes
    from repro_torch.lm.steps import (flatten, lm_adam_init, make_decode_step,
                                      make_prefill_step, make_train_step)

    contexts = {p: make_execution_context("data=1", profile=p, device=dev, backend="nccl")
                for p in ("2d", "fsdp")}
    for name, depth in PHASE13_NCCL:
        cfg = ARCHS[name] if depth is None else dataclasses.replace(ARCHS[name], n_layers=depth)
        train = 4 * param_bytes(abstract_params(cfg)) <= PHASE12_TRAIN_BYTES
        params = init_params(cfg, seed=0, device=dev)
        batch = _phase12_batch(torch, cfg, 1, PHASE12_SEQ, dev)

        def run(mesh=None, dp=()):
            caches, pre = make_prefill_step(cfg, mesh, dp, cache_margin=PHASE12_DECODE)(
                params, batch)
            tok = pre[:, -1:].float().argmax(-1)
            dec, _ = make_decode_step(cfg, mesh, dp)(params, caches, tok, PHASE12_SEQ)
            del caches
            res = {"prefill": pre, "decode": dec}
            if train:
                p = {k: v.clone() for k, v in flatten(params).items()}
                from repro_torch.lm.steps import _unflatten

                tree = _unflatten(p)
                _, _, res["loss"] = make_train_step(cfg, mesh, dp)(tree, lm_adam_init(tree), batch)
                res["params"] = flatten(tree)
            torch.cuda.synchronize()
            return res

        want = run()
        for profile, ctx in contexts.items():
            got = run(ctx.mesh, dp_axes(ctx.mesh, profile))
            same = {k: (all(torch.equal(got[k][n], want[k][n]) for n in want[k])
                        if isinstance(want[k], dict) else torch.equal(got[k], want[k]))
                    for k in want}
            out[name, profile] = {"bitwise": same, "counts": ctx.mesh.stats()}
            del got
        del params, want
        torch.cuda.empty_cache()


def _phase13_rank(rank: int, world: int, backend: str, work: str) -> None:
    """One rank of phase 13 (a) (spawned); pickles what it saw."""
    import datetime
    import pickle

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{work}/pg13_{backend}{world}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    out = {}
    dev = torch.device("cuda:0")
    if backend == "nccl":
        _phase13_nccl(torch, dev, out)
    else:
        _phase13_gloo(torch, dev, rank, out)
    with open(os.path.join(work, f"p13_{backend}{world}.r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _phase13_spawn(world: int, backend: str, work: str) -> list:
    import pickle

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    pc = mp.start_processes(_phase13_rank, args=(world, backend, work), nprocs=world,
                            join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while not pc.join(timeout=1):
            if time.monotonic() > deadline:
                fail(f"phase 13: the {world}-rank {backend} spawn ran past {RANK_TIMEOUT_S} s")
    except ProcessException as e:
        fail(f"phase 13: a {backend} rank failed: {e}")
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    out = []
    for r in range(world):
        with open(os.path.join(work, f"p13_{backend}{world}.r{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _phase13_against_card(torch, dev, card) -> None:
    """(b) The single-device dry run of a step against the step on the card:
    FLOPs equal to ``FlopCounterMode``'s count there, the reckoned peak
    within PHASE13_PEAK_TOL of the step's own peak (``max_memory_allocated``
    less what was allocated before its parameters), and the measured step
    time beside three reckoned bounds: the dry run's (eager traffic, an
    upper bound on the bytes a step must move, so its share reads high), the
    compute term alone, and a minimal-bytes bound (each argument read once,
    each output written once, or the compute term where larger)."""
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ARCHS
    from repro_torch.distributed import VirtualMesh
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.roofline import HBM_BW
    from repro_torch.lm.model import init_params
    from repro_torch.lm.shapes import ShapeCell
    from repro_torch.lm.steps import lm_adam_init, make_prefill_step, make_train_step

    for name, depth, kind in PHASE13_DRY:
        cfg = ARCHS[name] if depth is None else dataclasses.replace(ARCHS[name], n_layers=depth)
        cell = ShapeCell(f"{kind}_1x{PHASE12_SEQ}", kind, PHASE12_SEQ, 1)
        rec = run_cell(name, cell, cfg=cfg, analyze=False,
                       mesh=VirtualMesh({"data": 1, "model": 1}))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()   # what earlier phases left
        params = init_params(cfg, seed=0, device=dev)
        batch = _phase12_batch(torch, cfg, 1, PHASE12_SEQ, dev)
        if kind == "train":
            opt = lm_adam_init(params)
            step = make_train_step(cfg)

            def once():
                return step(params, opt, batch)
        else:
            batch.pop("labels")
            step = make_prefill_step(cfg)

            def once():
                return step(params, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            r = once()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del r
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            r = once()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del r
        step_s = statistics.median(times)
        dry_peak = rec["memory"]["peak_bytes"]
        flops = fc.get_total_flops()
        rf = rec["roofline"]
        mem = rec["memory"]
        least_s = max(rf["compute_s"], (mem["argument_bytes"] + mem["output_bytes"]) / HBM_BW)
        gap = abs(dry_peak - peak) / peak
        print(f"phase 13 (b) {name} ({cfg.n_layers} layers) {kind} 1 x {PHASE12_SEQ}: dry-run "
              f"FLOPs {rec['cost_exact']['flops']:.6g}, FlopCounterMode on the card "
              f"{flops:.6g}; peak reckoned {dry_peak / 1e9:.3f} GB, "
              f"the step's max_memory_allocated {peak / 1e9:.3f} GB ({100 * gap:.2f}% apart, "
              f"gate {100 * PHASE13_PEAK_TOL:.0f}%); step {step_s * 1e3:.1f} ms measured; "
              f"reckoned from {rf['constants']}: eager-traffic bound "
              f"{rf['bound_s'] * 1e3:.2f} ms ({rf['dominant']}), "
              f"{100 * rf['bound_s'] / step_s:.2f}% of the step; compute "
              f"{rf['compute_s'] * 1e3:.2f} ms, {100 * rf['compute_s'] / step_s:.2f}%; "
              f"minimal-bytes bound {least_s * 1e3:.2f} ms, {100 * least_s / step_s:.2f}% "
              f"| {card}")
        if rec["cost_exact"]["flops"] != flops:
            fail(f"phase 13 (b) {name}: dry-run FLOPs {rec['cost_exact']['flops']} != the "
                 f"card's {flops}")
        if gap > PHASE13_PEAK_TOL:
            fail(f"phase 13 (b) {name}: reckoned peak {dry_peak} bytes {100 * gap:.1f}% from "
                 f"the step's max_memory_allocated {peak}")
        del params, batch, step
        if kind == "train":
            del opt
        torch.cuda.empty_cache()


def _phase13_sweep() -> None:
    """(c) The dry-run sweep on this host (single-pod and multi-pod, and
    the NGDB cell dense and sparse) over PHASE13_SUBSET, each cell in a
    process of its own."""
    import concurrent.futures
    import multiprocessing

    from repro_torch.configs import ARCHS
    from repro_torch.launch.dryrun import _run
    from repro_torch.lm.shapes import SHAPES

    cells = [(a, s) for a, s in PHASE13_SUBSET]
    assert {a for a, _ in cells} == set(ARCHS) and {s for _, s in cells} == set(SHAPES)
    # The whole programs only: the k-extrapolation cross-check is the CPU
    # tests' (tests/test_torch_dryrun.py).
    runs = [(a, s, mp, False, False) for mp in (False, True) for a, s in cells]
    runs += [("ngdb", None, False, False, sparse) for sparse in (False, True)]
    # The prefill_32k cells trace for ~100 s each, the rest for seconds:
    # starting them first keeps the sweep's wall near the longest cell.
    runs.sort(key=lambda r: r[1] != "prefill_32k")
    t0 = time.perf_counter()
    jobs = min(8, os.cpu_count() or 1)
    with concurrent.futures.ProcessPoolExecutor(
            jobs, mp_context=multiprocessing.get_context("spawn"),
            max_tasks_per_child=1) as pool:
        recs = list(pool.map(_run, *zip(*runs)))
    for rec, (a, s, mp, _, sparse) in zip(recs, runs):
        if "error" in rec:
            fail(f"phase 13 (c) {a} {s} {'multi-pod' if mp else 'single-pod'}: "
                 f"{rec['error'][-2000:]}")
        rf = rec["roofline"]
        label = (f"{rec['arch']} {rec['shape']}" + (" sparse" if sparse else "")
                 + f" {rec['mesh']}")
        print(f"phase 13 (c) {label}: peak {rec['memory']['peak_bytes'] / 1e9:.2f} GB a device, "
              f"{rf['dominant']} bound {rf['bound_s'] * 1e3:.3f} ms (reckoned from "
              f"{rf['constants']}; its memory term from eager traffic), traced in "
              f"{rec['trace_s']:.1f} s")
    print(f"phase 13 (c): {len(runs)} cells (every architecture and shape, both meshes, "
          f"the NGDB cell dense and sparse) in {time.perf_counter() - t0:.1f} s on {jobs} "
          f"host processes; the full sweep is over 180 s (PERF.md)")


def phase13(torch, dev, card) -> None:
    """The LM zoo over a mesh, and its dry run (module docstring, 13)."""
    import shutil
    import tempfile

    t13 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="phase13_")
    try:
        # (a) One NCCL rank: bitwise the single-device steps.
        (nccl,) = _phase13_spawn(1, "nccl", work)
        for (name, profile), r in nccl.items():
            if not all(r["bitwise"].values()):
                fail(f"phase 13 (a) {name} data=1 {profile}: not bitwise the single-device "
                     f"steps: {r['bitwise']}")
            print(f"phase 13 (a) one NCCL rank, data=1 {profile}, {name}: "
                  f"{', '.join(sorted(r['bitwise']))} bitwise the single-device steps "
                  f"(collectives {r['counts']['counts']})")
        print(f"phase 13 (a) one NCCL rank in {time.perf_counter() - t13:.1f} s")
        # (a) Two gloo ranks on the card, fp32 compute.
        gloo = _phase13_spawn(2, "gloo", work)
        worst = {"logits": -1.0, "loss": 0.0, "m": 0.0}
        for rank, res in enumerate(gloo):
            for case, r in res.items():
                if r["counts"] != r["virtual"]:
                    fail(f"phase 13 (a) gloo rank {rank} {case}: ProcessMesh counts "
                         f"{r['counts']} != the virtual mesh's {r['virtual']}")
                if r["logits"] > 1e-4 or r["loss"] > 1e-4 or r["m"] > PHASE12_MOMENT_TOL:
                    fail(f"phase 13 (a) gloo rank {rank} {case}: logits excess {r['logits']:.3g} "
                         f"(rtol 1e-4, atol 1e-4), loss {r['loss']:.3g} (1e-4), Adam m "
                         f"{r['m']:.3g} of its norm ({PHASE12_MOMENT_TOL})")
                for k in worst:
                    worst[k] = max(worst[k], r[k])
        print(f"phase 13 (a) two gloo ranks on the card ({', '.join(s for s, _, _ in PHASE13_MESHES)}; "
              f"ten reduced architectures, seq_shard off and on, mixtral/jamba tp and ep; fp32): "
              f"{len(gloo[0])} cases a rank, logits/prefill/decode at most "
              f"{worst['logits']:.3g} past 1e-4 of the single-device steps' magnitude (gate "
              f"atol 1e-4), losses within "
              f"{worst['loss']:.3g}, step-1 Adam m within {worst['m']:.3g} of its norm; every "
              f"ProcessMesh counter equal to a VirtualMesh's over the same program "
              f"| (a) in {time.perf_counter() - t13:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # (b) The dry run against the card.
    tb = time.perf_counter()
    _phase13_against_card(torch, dev, card)
    print(f"phase 13 (b) in {time.perf_counter() - tb:.1f} s")
    # (c) The sweep.
    _phase13_sweep()
    print(f"LM zoo over a mesh: phase 13 in {time.perf_counter() - t13:.1f} s")



# --------------------------- 14. live writes and hot swaps under a mesh
PHASE14_STALENESS = 4      # max_staleness_versions, as phase 7
PHASE14_BURST = 64         # fresh triples a burst
PHASE14_NEW = 16           # entities the growth burst adds
PHASE14_LOOP = 448         # closed-loop requests through the writer's 8 bursts
PHASE14_FT = dict(finetune_steps=4, n_negatives=8, seed=0)
# Two ranks against single-device, each fine-tune's update norm-wise: Adam
# moves an element by about lr whatever its gradient's size, so an element
# whose gradient is rounding noise (the batch split over ranks sums it in
# another order) may step the other way, and no element-wise bound on
# the fine-tuned values holds (BetaE on the card: 0.37 lr at one entity
# element, 1.99 times test_torch_live.py's tolerance). A fine-tune skipped,
# doubled or on the wrong rows is 1.0 or more.
PHASE14_UPDATE_TOL = 0.05


def _phase14_bursts(kg, n: int, grow: int, seed: int) -> list:
    """``n`` bursts of ``PHASE14_BURST`` triples fresh against ``kg`` and one
    another; burst ``grow`` uses the ``PHASE14_NEW`` ids above the graph's
    entities as heads and as tails."""
    rng = np.random.default_rng(seed)
    e, r = kg.n_entities, kg.n_relations
    m = 4 * n * PHASE14_BURST
    cand = np.stack([rng.integers(0, e, m), rng.integers(0, r, m), rng.integers(0, e, m)],
                    axis=1)
    cand = np.unique(cand[~kg.contains(cand)], axis=0)
    cand = cand[rng.permutation(len(cand))][:n * PHASE14_BURST]
    out = [cand[i * PHASE14_BURST:(i + 1) * PHASE14_BURST].copy() for i in range(n)]
    new = np.arange(e, e + PHASE14_NEW)
    out[grow][:2 * PHASE14_NEW, 0] = np.repeat(new, 2)
    out[grow][2 * PHASE14_NEW:3 * PHASE14_NEW, 2] = new
    return out


def _phase14_whole(ctx, model, params) -> dict:
    """``params`` gathered whole, as host arrays (collective under a mesh;
    the entity rows read off the block: retained sets predate growth)."""
    if ctx is None:
        return {k: v.cpu().numpy() for k, v in sorted(params.items())}
    axes = ctx.row_axes("entity", model.full_shapes["entity"])
    shapes = {**model.full_shapes,
              "entity": (params["entity"].shape[0] * ctx.mesh.ways(axes),
                         params["entity"].shape[1])}
    return {k: ctx.gather(k, v, shapes[k]).cpu().numpy() for k, v in sorted(params.items())}


def _phase14_hash(obj) -> str:
    """A hash of ``obj``'s values: arrays by their bytes, the rest by repr."""
    import hashlib

    h = hashlib.sha256()

    def walk(o):
        if isinstance(o, np.ndarray):
            h.update(f"{o.dtype}{o.shape}".encode())
            h.update(np.ascontiguousarray(o).tobytes())
        elif isinstance(o, dict):
            for k in sorted(o):
                h.update(repr(k).encode())
                walk(o[k])
        elif isinstance(o, (list, tuple)):
            h.update(b"[")
            for x in o:
                walk(x)
            h.update(b"]")
        else:
            h.update(repr(o).encode())

    walk(obj)
    return h.hexdigest()


def _phase14_script(torch, family, ctx, kg, qs, bursts, dev, pad) -> dict:
    """The deterministic write script on one engine (rank 0 submits and
    writes, the others follow): whole 16-request batches, pinned ones among
    them, and between them bursts A, B (growth), C and D, each flushed. The
    result keeps every answer, every published params set gathered whole,
    the graph versions, counters, the entity block, and each write's
    collectives and lane hold."""
    from repro_torch.core import MaterializedSubqueryCache, PooledExecutor
    from repro_torch.kernels import ops as kops
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.serving import LiveNGDB, ServingConfig, ServingEngine, StaleVersionError

    model = make_model(family, ModelConfig(entity_pad=pad), device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(141), kg.n_entities,
                               kg.n_relations, ctx=ctx)
    mat = MaterializedSubqueryCache(2048)
    mat.watch_kg(kg)
    cfg = ServingConfig(max_batch=16, max_wait_ms=2000.0, top_k=TOP_K, record_batches=True,
                        max_staleness_versions=PHASE14_STALENESS)
    eng = ServingEngine(model, params, executor=PooledExecutor(model, b_max=256, device=dev,
                                                               ctx=ctx),
                        cfg=cfg, device=dev, kg=kg, mat_cache=mat, ctx=ctx)
    published, writes = [], []
    swap = eng._swap

    def recorded(p):
        published.append(p)
        swap(p)

    eng._swap = recorded
    live = LiveNGDB(model, kg, eng, **PHASE14_FT)
    mesh = ctx.mesh if ctx is not None else None
    apply_write = live._apply_write

    def counted_write(*a):
        # The write itself, on every rank (under the lane on rank 0).
        c0, b0 = dict(mesh.counts), sum(mesh.bytes.values())
        receipt = apply_write(*a)
        writes.append({"collectives": sum(mesh.counts.values()) - sum(c0.values()),
                       "bytes": sum(mesh.bytes.values()) - b0})
        return receipt

    if mesh is not None:
        live._apply_write = counted_write
    launches0 = (kops.scoring.launches, kops.intersect.launches)
    out = {"answers": [], "versions": []}
    t0 = time.perf_counter()
    if eng.leader:
        v0 = kg.graph_version

        def serve(unpinned, pinned=()):
            fs = eng.submit_many(unpinned)
            for q, v in pinned:
                try:
                    fs.append(eng.submit(q, pin_version=v))
                except StaleVersionError:
                    out["answers"].append("stale")
            for f in fs:
                try:
                    r = f.result(timeout=RANK_TIMEOUT_S)
                    out["answers"].append({k: r[k] for k in ("top_entities", "scores")})
                except StaleVersionError:
                    out["answers"].append("stale")

        def write(b, n_new=0):
            live.write(bursts[b], n_new_entities=n_new)
            live.flush()
            out["versions"].append(kg.graph_version)

        serve(qs[:32])
        write(0)
        serve(qs[32:48], [(q, v0) for q in qs[48:64]])
        write(1, PHASE14_NEW)
        vb = kg.graph_version
        serve(qs[64:80], [(q, v0) for q in qs[80:96]] + [(q, vb - 1) for q in qs[96:112]])
        write(2)
        write(3)
        serve(qs[112:128], [(q, v0) for q in qs[128:144]]
              + [(q, kg.graph_version - 1) for q in qs[144:160]])
        live.close()
        eng.close()
    else:
        eng.follow()
        eng.close()
        live.close()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {"scoring": kops.scoring.launches - launches0[0],
                       "intersect": kops.intersect.launches - launches0[1]}
    st = eng.stats()
    out["stats"] = {k: st[k] for k in ("graph_version", "retained_versions", "stale_sheds",
                                       "version_lag_served", "failures", "batches")}
    out["stats"]["mat"] = {k: st["mat_cache"][k] for k in ("hits", "misses", "live")}
    out["finetune_ms"] = [1e3 * t for t in live.finetune_s]
    out["reblock_bytes"] = live.reblock_bytes
    out["writes"] = writes
    out["hold_ms"] = ({k: [1e3 * t for t in v] for k, v in eng._lane.hold_s.items()}
                      if eng._lane is not None else {})
    out["block"] = tuple(eng.params["entity"].shape)
    out["full"] = tuple(model.full_shapes["entity"])
    out["params"] = [_phase14_whole(ctx, model, p) for p in [params] + published]
    # This rank's block is exactly its rows of the grown table.
    n = out["block"][0]
    lo = ctx.mesh.index(ctx.row_axes("entity", model.full_shapes["entity"])) * n if ctx else 0
    out["own_block"] = bool(np.array_equal(eng.params["entity"].cpu().numpy(),
                                           out["params"][-1]["entity"][lo:lo + n]))
    out["digest"] = _phase14_hash(
        ([[q.key() for q in rec.queries]
          + [{k: r[k] for k in ("top_entities", "scores")} for r in rec.results]
          for rec in eng.batch_log], out["params"]))
    return out


def _answers_gap(got, want, d: int) -> tuple:
    """Answers against the ones they should match: the largest excess of a
    score over rtol 1e-4, atol 1e-4·d (``d`` the entity rows' width; plus
    the 3-place rounding), and whether the top-k ids agree wherever the gap
    after a position exceeds that tolerance."""
    atol = 1e-4 * d + 1e-3
    worst, topk = 0.0, True
    for g, w in zip(got, want):
        gs, ws = np.asarray(g["scores"]), np.asarray(w["scores"])
        worst = max(worst, float(np.max(np.abs(gs - ws) / (atol + 1e-4 * np.abs(ws)))))
        for j in range(len(ws) - 1):
            if (ws[j] - ws[j + 1] > atol + 1e-4 * abs(ws[j])
                    and set(g["top_entities"][:j + 1]) != set(w["top_entities"][:j + 1])):
                topk = False
    return worst, topk


def _phase14_compare(got, want, rtol: float) -> dict:
    """A mesh script's result against single-device's: answers within rtol
    1e-4, atol 1e-4·d (plus the 3-place rounding), top-k ids by the gap rule,
    the same sheds; each published params set within ``rtol``, atol
    rtol·1e-2·(the Adam steps behind it); the largest excess over the
    tolerance of each (<= 1 holds)."""
    pairs = list(zip(got["answers"], want["answers"]))
    sheds = all(g == w for g, w in pairs if g == "stale" or w == "stale")
    served = [(g, w) for g, w in pairs if g != "stale" and w != "stale"]
    ans, topk = _answers_gap([g for g, _ in served], [w for _, w in served],
                             want["params"][0]["entity"].shape[1])
    # Sets: 0 the initial params, 2 the growth's, the others fine-tunes'.
    par, upd, steps, grown = 0.0, 0.0, 0, True
    gp, wp = got["params"], want["params"]
    for i in range(1, min(len(gp), len(wp))):
        p, q = gp[i], wp[i]
        if i == 2:
            n = gp[1]["entity"].shape[0]
            grown = bool(np.array_equal(p["entity"][n:], q["entity"][n:]))
            continue
        steps += PHASE14_FT["finetune_steps"]
        for k in q:
            if not q[k].size or k in ("sem_table",):
                continue
            tol = rtol * 1e-2 * steps + rtol * np.abs(q[k])
            par = max(par, float(np.max(np.abs(p[k] - q[k]) / tol)))
            # This fine-tune's update, rows the set before held.
            rows = min(gp[i - 1][k].shape[0], q[k].shape[0])
            dp, dq = p[k][:rows] - gp[i - 1][k][:rows], q[k][:rows] - wp[i - 1][k][:rows]
            if np.linalg.norm(dq) > 0:
                upd = max(upd, float(np.linalg.norm(dp - dq) / np.linalg.norm(dq)))
    return {"answers": ans, "topk": topk, "sheds": sheds and len(got["answers"])
            == len(want["answers"]), "params": par, "update": upd, "grown": grown,
            "n_params": (len(gp), len(wp))}


def _phase14_loop(torch, ctx, kg, qs, bursts, dev) -> dict:
    """(a)'s closed loop of 32 on rank 0 (every fourth request pinned up to
    6 versions behind) while a writer thread lands 8 bursts, the fourth
    growing 16 entities. Every request served or shed typed; pinned replays
    bitwise ``serve_batch`` on the retained params and entity count; the
    params after ``flush()`` bitwise a sync ``incremental_finetune`` (under
    ``ctx``) of burst 8 from its recorded inputs."""
    from repro_torch.core import MaterializedSubqueryCache, PooledExecutor
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.serving import (LiveNGDB, ServingConfig, ServingEngine, StaleVersionError,
                                     check_against_offline, latency_summary)
    from repro_torch.training import incremental_finetune

    model = make_model("gqe", ModelConfig(), device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(142), kg.n_entities,
                               kg.n_relations, ctx=ctx)
    mat = MaterializedSubqueryCache(2048)
    mat.watch_kg(kg)
    eng = ServingEngine(model, params, executor=PooledExecutor(model, b_max=256, device=dev,
                                                               ctx=ctx),
                        cfg=ServingConfig(max_batch=16, top_k=TOP_K,
                                          max_staleness_versions=PHASE14_STALENESS),
                        device=dev, kg=kg, mat_cache=mat, ctx=ctx)
    live = LiveNGDB(model, kg, eng, **PHASE14_FT)
    rng = np.random.default_rng(143)
    rec = {}
    warm, work = qs[:64], qs[64:64 + PHASE14_LOOP]
    for f in eng.submit_many(warm):
        f.result(timeout=RANK_TIMEOUT_S)

    def writer():
        for b, triples in enumerate(bursts):
            time.sleep(0.02)
            if b == 7:
                live.flush()
                rec["p_in"] = eng.params
            rec[b] = live.write(triples, n_new_entities=PHASE14_NEW if b == 3 else 0)

    wt = threading.Thread(target=writer, name="chip-smoke-writer")
    window, served, shed = collections.deque(), [], 0
    t0 = time.perf_counter()
    wt.start()

    def settle(f):
        nonlocal shed
        try:
            served.append(f.result(timeout=RANK_TIMEOUT_S))
        except StaleVersionError:
            shed += 1

    for i, q in enumerate(work):
        while len(window) >= 32:
            settle(window.popleft())
        pin = None
        if i % 4 == 3:
            pin = max(0, eng.graph_version - int(rng.integers(0, 7)))
        try:
            window.append(eng.submit(q, pin_version=pin))
        except StaleVersionError:
            shed += 1
    while window:
        settle(window.popleft())
    wall = time.perf_counter() - t0
    wt.join()
    live.flush()
    lat = latency_summary([r["latency_ms"] for r in served])
    st = eng.stats()
    out = {"served": len(served), "shed": shed, "n": len(work), "failures": st["failures"],
           "qps": len(served) / wall, "p99": lat["p99"], "finetune_ms":
           [1e3 * t for t in live.finetune_s], "graph_version": st["graph_version"],
           "finite": all(len(r["top_entities"]) == TOP_K and np.isfinite(r["scores"]).all()
                         for r in served)}
    # Pinned replay: fresh keys pinned to the version after the growth burst.
    v = rec[3].graph_version
    p_v, n_v = eng.params_at(v)
    eng.batch_log, eng.cfg.record_batches = [], True
    pinned = [q for q in qs[64 + PHASE14_LOOP:] if q.key() not in {w.key() for w in work}][:32]
    for f in [eng.submit(q, pin_version=v) for q in pinned]:
        f.result(timeout=RANK_TIMEOUT_S)
    eng.cfg.record_batches = False
    ex = PooledExecutor(model, b_max=256, device=dev, ctx=ctx)
    out["replayed"] = check_against_offline(
        eng.batch_log, lambda b: serve_batch(model, p_v, ex, b, top_k=TOP_K, device=dev,
                                             n_entities=n_v, ctx=ctx)[0])
    out["pinned"] = len(pinned)
    sync, _ = incremental_finetune(model, rec["p_in"], rec[7].fresh_triples,
                                   steps=PHASE14_FT["finetune_steps"], lr=live.finetune_lr,
                                   n_negatives=PHASE14_FT["n_negatives"],
                                   seed=live.seed + rec[7].graph_version, ctx=ctx)
    out["sync_equal"] = all(torch.equal(eng.params[k], sync[k]) for k in sync)
    live.close()
    eng.close()
    return out


def _phase14_semantic(torch, ctx, kg, qs, burst, dev, work) -> dict:
    """(c): GQE with resident H_sem (d_l 1024, random rows in a store of its
    own) on the NCCL rank, one growth burst with ``sem_rows``."""
    from repro_torch.core import OpType, PooledExecutor
    from repro_torch.kernels import ops as kops
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.semantic import SemanticStore, SemanticStoreWriter
    from repro_torch.serving import LiveNGDB, ServingConfig, ServingEngine

    rng = np.random.default_rng(144)
    n = kg.n_entities
    table = rng.standard_normal((n, SEM_DIM), dtype=np.float32) / np.float32(32.0)
    sdir = os.path.join(work, "p14_store")
    w = SemanticStoreWriter(sdir, dim=SEM_DIM, shard_rows=CHUNK)
    w.append(table)
    w.finalize()
    store = SemanticStore(sdir)
    old = store.read_rows(np.arange(n))
    appends = []
    append = store.append_rows
    store.append_rows = lambda rows: appends.append(len(rows)) or append(rows)
    model = make_model("gqe", ModelConfig(semantic_dim=SEM_DIM), device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(145), n, kg.n_relations,
                               semantic_table=table, ctx=ctx)
    del table
    ex = PooledExecutor(model, b_max=256, device=dev, ctx=ctx)
    eng = ServingEngine(model, params, executor=ex,
                        cfg=ServingConfig(max_batch=16, max_wait_ms=2000.0, top_k=TOP_K,
                                          record_batches=True,
                                          max_staleness_versions=PHASE14_STALENESS),
                        device=dev, kg=kg, ctx=ctx)
    live = LiveNGDB(model, kg, eng, store=store, **PHASE14_FT)
    kops.gather_fuse.launches = kops.gather_fuse_backward.launches = 0
    sem_new = rng.standard_normal((PHASE14_NEW, SEM_DIM), dtype=np.float32) / np.float32(32.0)
    for f in eng.submit_many(qs[:32]):
        f.result(timeout=RANK_TIMEOUT_S)
    r = live.write(burst, n_new_entities=PHASE14_NEW, sem_rows=sem_new)
    live.flush()
    for f in eng.submit_many(qs[32:64]):
        f.result(timeout=RANK_TIMEOUT_S)
    live.close()
    eng.close()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    embed = lambda queries, b_max: sum(  # noqa: E731
        1 for op, _c, _p in PooledExecutor(model, b_max=b_max, device=dev).prepare(
            queries).meta if op == int(OpType.EMBED))
    from repro_torch.core import QueryInstance

    ft_queries = [QueryInstance("1p", np.array([h]), np.array([rr]))
                  for h, rr, _ in r.fresh_triples]
    ft = PHASE14_FT["finetune_steps"] * (embed(ft_queries, 64) + 1)
    want = sum(embed(rec.queries, 256) + 1 for rec in eng.batch_log) + ft
    return {"appends": appends, "rows": store.n_rows, "n": n,
            "old_equal": bool(np.array_equal(store.read_rows(np.arange(n)), old)),
            "new_equal": bool(np.array_equal(store.read_rows(np.arange(n, n + PHASE14_NEW)),
                                             sem_new)),
            "launches": (kops.gather_fuse.launches, kops.gather_fuse_backward.launches),
            "want": (want, ft), "finetunes": live.finetunes_done}


def _phase14_tier(torch, ctx, kg, qs, dev) -> dict:
    """(d): ``ReplicaPool(2)`` behind a ``Router``: half a stream,
    ``update_params`` at once (the first half still queued), the other half.
    Each batch: the params version it ran on, which half its queries came
    from, and whether it is bitwise ``serve_batch`` on those params."""
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.serving import ReplicaPool, Router, ServingConfig

    model = make_model("gqe", ModelConfig(entity_pad=ctx.n_devices), device=dev)
    params_a = model.init_params(torch.Generator(device=dev).manual_seed(146), kg.n_entities,
                                 kg.n_relations, ctx=ctx)
    params_b = {**params_a, "entity": params_a["entity"] * 1.5}
    pool = ReplicaPool(model, params_a, n_replicas=2, b_max=256, device=dev, ctx=ctx,
                       cfg=ServingConfig(max_batch=16, top_k=TOP_K, record_batches=True))
    first, second = qs[:64], qs[64:128]
    if ctx.rank == 0:
        router = Router(pool)
        fa = router.submit_many(first)
        router.update_params(params_b)
        fb = router.submit_many(second)
        for f in fa + fb:
            f.result(timeout=RANK_TIMEOUT_S)
        router.close()
    else:
        pool.update_params(params_b)   # staged: applied when swap 1 arrives
        pool.follow()
        pool.close()
    keys_a, keys_b = {q.key() for q in first}, {q.key() for q in second}
    batches = []
    for rid, rep in sorted(pool.replicas().items()):
        for rec in rep.engine.batch_log:
            keys = {q.key() for q in rec.queries[:rec.n_real]}
            half = ("first" if keys <= keys_a - keys_b else
                    "second" if keys <= keys_b - keys_a else "both")
            res, _ = serve_batch(model, params_a if rec.params_version == 0 else params_b,
                                 rep.executor, rec.queries, top_k=TOP_K, device=dev, ctx=ctx)
            same = [{k: x[k] for k in ("top_entities", "scores")} for x in rec.results] == [
                {k: x[k] for k in ("top_entities", "scores")} for x in res[:rec.n_real]]
            batches.append((rid, rec.params_version, half, same))
    hold = [1e3 * t for t in pool.replicas()[0].engine._lane.hold_s["swap"]]
    return {"batches": batches, "swap_hold_ms": hold,
            "digest": _phase14_hash([[q.key() for q in rec.queries]
                                     + [{k: x[k] for k in ("top_entities", "scores")}
                                        for x in rec.results]
                                     for rep in pool.replicas().values()
                                     for rec in rep.engine.batch_log])}


def _phase14_rank(rank: int, world: int, backend: str, work: str) -> None:
    """One rank of phase 14 (spawned): one NCCL rank ((a), (c), (d)) or two
    gloo ranks sharing the card ((b), (d)). Pickles what it saw (gates
    evaluated here where they need the params) to
    ``work/p14_<backend><world>.r<rank>.pkl``."""
    import datetime
    import pickle

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        dev = torch.device(pickle.load(f)["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{work}/pg14_{backend}{world}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    from repro_torch.data import KnowledgeGraph, generate_synthetic_kg
    from repro_torch.distributed import make_execution_context
    from repro_torch.kernels import ops as kops
    from repro_torch.serving import make_workload

    t0 = time.perf_counter()
    kg0 = generate_synthetic_kg(*FB15K, seed=0, name="FB15k-shaped")

    def fresh():
        return KnowledgeGraph(kg0.n_entities, kg0.n_relations, kg0.triples.copy(),
                              name=kg0.name)

    qs = make_workload(kg0, 64 + PHASE14_LOOP + 256, seed=7)
    script_bursts = _phase14_bursts(kg0, 4, 1, seed=147)
    out = {"script": {}}
    if world == 1:
        ctx = make_execution_context("data=1", profile="fsdp", device=dev, backend=backend)
        got = _phase14_script(torch, "gqe", ctx, fresh(), qs, script_bursts, dev, 1)
        want = _phase14_script(torch, "gqe", None, fresh(), qs, script_bursts, dev, 1)
        out["a_bitwise"] = {  # the initial params, the growth's and 4 fine-tunes' 
            "answers": got["answers"] == want["answers"],
            "versions": got["versions"] == want["versions"],
            "stats": got["stats"] == want["stats"],
            "params": len(got["params"]) == len(want["params"]) and all(
                p.keys() == q.keys() and all(np.array_equal(p[k], q[k]) for k in p)
                for p, q in zip(got["params"], want["params"]))}
        for r in (got, want):
            r["params"] = None
        out["script"]["mesh"], out["script"]["single"] = got, want
        loop_bursts = _phase14_bursts(kg0, 8, 3, seed=148)
        kops.scoring.launches = 0
        out["loop"] = _phase14_loop(torch, ctx, fresh(), qs, loop_bursts, dev)
        out["loop"]["scoring"] = kops.scoring.launches
        out["loop_single"] = _phase14_loop(torch, None, fresh(), qs, loop_bursts, dev)
        out["semantic"] = _phase14_semantic(torch, ctx, fresh(), qs, script_bursts[1], dev,
                                            work)
        out["tier"] = _phase14_tier(torch, ctx, kg0, qs, dev)
    else:
        for spec, profile in (("data=2", "fsdp"), ("data=1,model=2", "2d")):
            ctx = make_execution_context(spec, profile=profile, device=dev, backend=backend)
            for family in ("gqe", "betae"):
                out["script"][spec, profile, family] = _phase14_script(
                    torch, family, ctx, fresh(), qs, script_bursts, dev, world)
        ctx = make_execution_context("data=2", profile="fsdp", device=dev, backend=backend)
        out["tier"] = _phase14_tier(torch, ctx, kg0, qs, dev)
        out["counts"] = ctx.mesh.stats()
        if rank == 0:
            # Single-device on the same padding, held here (the params stay
            # in this process).
            for family, rtol in (("gqe", 1e-4), ("betae", 1e-3)):
                want = _phase14_script(torch, family, None, fresh(), qs, script_bursts, dev,
                                       world)
                for key, got in out["script"].items():
                    if key[2] == family:
                        got["vs_single"] = _phase14_compare(got, want, rtol)
        for got in out["script"].values():
            got["params"] = None
    out["seconds"] = time.perf_counter() - t0
    with open(os.path.join(work, f"p14_{backend}{world}.r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _phase14_spawn(world: int, backend: str, work: str) -> list:
    import pickle

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    pc = mp.start_processes(_phase14_rank, args=(world, backend, work), nprocs=world,
                            join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while not pc.join(timeout=1):
            if time.monotonic() > deadline:
                fail(f"phase 14: the {world}-rank {backend} spawn ran past {RANK_TIMEOUT_S} s")
    except ProcessException as e:
        fail(f"phase 14: a {backend} rank failed: {e}")
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    out = []
    for r in range(world):
        with open(os.path.join(work, f"p14_{backend}{world}.r{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _phase14_tier_gate(label: str, ts: list) -> None:
    for r, t in enumerate(ts):
        pvs = {pv for _, pv, _, _ in t["batches"]}
        wrong = [(rid, pv, half) for rid, pv, half, _ in t["batches"]
                 if half == ("second" if pv == 0 else "first")]
        if pvs != {0, 1} or wrong or not all(same for *_, same in t["batches"]):
            fail(f"phase 14 (d) {label}: rank {r}'s batches broke the swap contract "
                 f"(params versions {pvs}, misplaced {wrong}) or differ from serve_batch")
    if len({t["digest"] for t in ts}) != 1:
        fail(f"phase 14 (d) {label}: the ranks' batches differ")


def phase14(main_path, card) -> None:
    """Live writes, background fine-tunes and hot swaps under a mesh (module
    docstring, 14). The ranks' launches are added to ``main_path``."""
    import pickle

    t14 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_live_")
    atexit.register(shutil.rmtree, work, ignore_errors=True)
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump({"device": "cuda:0"}, f)
    added = collections.Counter()
    stat = lambda xs: (f"median {statistics.median(xs):.2f}, max {max(xs):.2f}"  # noqa: E731
                       if xs else "none")

    # (a), (c), (d): one NCCL rank.
    (nccl,) = _phase14_spawn(1, "nccl", work)
    a, s = nccl["script"]["mesh"], nccl["script"]["single"]
    if not all(nccl["a_bitwise"].values()):
        fail(f"phase 14 (a): the one-rank script is not bitwise single-device's: "
             f"{nccl['a_bitwise']}")
    if (a["stats"]["stale_sheds"] != 16 or a["stats"]["failures"] or a["block"] != a["full"]
            or not a["own_block"]):
        fail(f"phase 14 (a): stats {a['stats']}, block {a['block']} of {a['full']}")
    added["scoring[l1]"] += a["launches"]["scoring"]
    print(f"phase 14 (a) one NCCL rank, data=1 fsdp, GQE: the write script (4 bursts of "
          f"{PHASE14_BURST}, burst 2 growing {PHASE14_NEW} entities, 160 requests, 16 shed "
          f"stale) bitwise single-device's: answers, {len(s['finetune_ms'])} fine-tunes' "
          f"params and the growth's, graph versions {a['versions']}, counters {a['stats']} | "
          f"script {a['seconds']:.1f} s (single-device {s['seconds']:.1f} s) | fine-tune ms "
          f"{[round(x, 1) for x in a['finetune_ms']]} | lane hold ms: write "
          f"{stat(a['hold_ms']['write'])}, fine-tune {stat(a['hold_ms']['finetune'])} | a "
          f"write's collectives {[w['collectives'] for w in a['writes']]}, bytes "
          f"{[w['bytes'] for w in a['writes']]} (re-block {a['reblock_bytes']}) | {card}")
    lp, ls = nccl["loop"], nccl["loop_single"]
    for label, o in (("mesh", lp), ("single-device", ls)):
        if o["served"] + o["shed"] != o["n"] or o["failures"] or not o["finite"]:
            fail(f"phase 14 (a) closed loop, {label}: {o['served']} served + {o['shed']} "
                 f"shed of {o['n']}, {o['failures']} failures, finite {o['finite']}")
        if o["replayed"] != o["pinned"] or not o["sync_equal"]:
            fail(f"phase 14 (a) closed loop, {label}: {o['replayed']} of {o['pinned']} pinned "
                 f"rows replayed bitwise; params after flush bitwise a sync rerun: "
                 f"{o['sync_equal']}")
    if lp["scoring"] == 0:
        fail("phase 14 (a): the scoring kernel was never launched")
    added["scoring[l1]"] += lp["scoring"]
    print(f"phase 14 (a) closed loop of 32, {lp['n']} requests through 8 bursts (burst 4 "
          f"growing {PHASE14_NEW}), one NCCL rank: {lp['served']} served, {lp['shed']} shed "
          f"stale, {lp['qps']:.1f} q/s, p99 {lp['p99']:.2f} ms (single-device in the same "
          f"process {ls['qps']:.1f} q/s, p99 {ls['p99']:.2f} ms) | fine-tune ms a burst "
          f"{stat(lp['finetune_ms'])} (single-device {stat(ls['finetune_ms'])}) | "
          f"{lp['pinned']} pinned rows replayed bitwise through serve_batch on the retained "
          f"params | params after flush bitwise a sync mesh incremental_finetune | scoring "
          f"launches {lp['scoring']} | {card}")
    c = nccl["semantic"]
    if (c["appends"] != [PHASE14_NEW] or c["rows"] != c["n"] + PHASE14_NEW
            or not (c["old_equal"] and c["new_equal"]) or c["finetunes"] != 1):
        fail(f"phase 14 (c): appends {c['appends']}, store rows {c['rows']}, old rows "
             f"bitwise {c['old_equal']}, new {c['new_equal']}, fine-tunes {c['finetunes']}")
    if c["launches"] != c["want"]:
        fail(f"phase 14 (c): gather_fuse, gather_fuse_backward launched {c['launches']}, "
             f"the plans call for {c['want']}")
    added["gather_fuse[resident]"] += c["launches"][0]
    added["gather_fuse_backward"] += c["launches"][1]
    print(f"phase 14 (c) GQE+H_sem resident (d_l {SEM_DIM}), one NCCL rank: the growth burst "
          f"appended its {PHASE14_NEW} rows once (store {c['n']} -> {c['rows']} rows, old "
          f"rows bitwise, new rows read back bitwise) | gather_fuse {c['launches'][0]}, "
          f"gather_fuse_backward {c['launches'][1]} launches = the plans' ops")
    _phase14_tier_gate("one NCCL rank", [nccl["tier"]])
    print(f"phase 14 (d) ReplicaPool(2) behind a Router, one NCCL rank: "
          f"{len(nccl['tier']['batches'])} batches, those of the first half on the old params "
          f"and of the second on the new, each bitwise serve_batch | lane hold ms a swap "
          f"{[round(x, 2) for x in nccl['tier']['swap_hold_ms']]}")
    print(f"phase 14 one NCCL rank in {nccl['seconds']:.1f} s")

    # (b), (d): two gloo ranks on the card.
    gloo = _phase14_spawn(2, "gloo", work)
    for key, r0 in gloo[0]["script"].items():
        spec, profile, family = key
        where = f"[gloo, 2 ranks, {spec}, {profile}, {family}]"
        r1 = gloo[1]["script"][key]
        # Rank 0 sheds stale pins before announcing: no other rank sees them.
        if r0["digest"] != r1["digest"] or r1["stats"] != {**r0["stats"], "stale_sheds": 0}:
            fail(f"phase 14 (b) {where}: the ranks' answers or params differ")
        ways = 2
        for r, o in enumerate((r0, r1)):
            if o["full"][0] != o["block"][0] * ways or not o["own_block"]:
                fail(f"phase 14 (b) {where}: rank {r} holds {o['block']} of {o['full']}")
        v = r0["vs_single"]
        if not (v["answers"] <= 1.0 and v["update"] <= PHASE14_UPDATE_TOL and v["topk"]
                and v["sheds"] and v["grown"] and v["n_params"][0] == v["n_params"][1] == 6):
            fail(f"phase 14 (b) {where}: against single-device {v}")
        k = "scoring" if family == "gqe" else "intersect"
        if r0["launches"][k] == 0:
            fail(f"phase 14 (b) {where}: {k} was never launched")
        for o in (r0, r1):
            added["scoring[l1]" if family == "gqe" else "intersect"] += o["launches"][k]
        print(f"phase 14 (b) {where}: answers and params bitwise equal on both ranks; "
              f"against single-device: answers at {v['answers']:.3g} of the tolerance, top-k "
              f"by the gap rule, each fine-tune's update at {v['update']:.3g} of its norm "
              f"(gate {PHASE14_UPDATE_TOL}; element-wise at {v['params']:.3g} of "
              f"test_torch_live.py's tolerance), grown rows bitwise; entity block "
              f"{r0['block']} of {r0['full']} | fine-tune ms {stat(r0['finetune_ms'])} | lane "
              f"hold ms: write {stat(r0['hold_ms']['write'])}, fine-tune "
              f"{stat(r0['hold_ms']['finetune'])} | a write's collectives "
              f"{[w['collectives'] for w in r0['writes']]}, bytes "
              f"{[w['bytes'] for w in r0['writes']]} (re-block {r0['reblock_bytes']}) | "
              f"{k} launches {[o['launches'][k] for o in (r0, r1)]} | {card}")
    _phase14_tier_gate("two gloo ranks", [g["tier"] for g in gloo])
    print(f"phase 14 (d) ReplicaPool(2) behind a Router, two gloo ranks (data=2 fsdp): "
          f"{len(gloo[0]['tier']['batches'])} batches a rank, the swap contract held on both, "
          f"each bitwise serve_batch, the ranks bitwise equal | lane hold ms a swap "
          f"{[round(x, 2) for x in gloo[0]['tier']['swap_hold_ms']]} | collectives of rank 0 "
          f"{gloo[0]['counts']['counts']}, staged {gloo[0]['counts']['staged']} | two gloo ranks "
          f"in {gloo[0]['seconds']:.1f} s")

    # (e) The serving CLI with live writes under torchrun.
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "1", "-m", "repro_torch.launch.serve", "--mesh", "data=1", "--profile", "fsdp",
            "--model", "gqe", "--requests", "64", "--top-k", str(TOP_K), "--live-writes", "2",
            "--max-staleness", "2", "--materialize", "2048"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=RANK_TIMEOUT_S,
                          cwd=work, env={**os.environ, "PYTHONPATH": str(SRC)})
    lines = proc.stdout.splitlines()
    if (proc.returncode != 0 or not any(l.startswith("live writes: 2 bursts") and
                                        "2 background fine-tunes" in l for l in lines)
            or not any(l.startswith("first: ") for l in lines)):
        fail(f"phase 14 (e): torchrun rc {proc.returncode}\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    print(f"phase 14 (e): {' '.join(argv[1:])} ({time.perf_counter() - t0:.1f} s)")
    for line in lines:
        if line.startswith(("execution context", "[closed]", "live ", "mesh lane",
                            "materialized rows")):
            print(f"  | {line[:300]}")
    for key, n in added.items():
        k_n, counter = main_path[key]
        main_path[key] = (k_n + n, counter)
    print(f"live writes under a mesh: launches {dict(added)} of the ranks added to the kernels "
          f"line | phase 14 in {time.perf_counter() - t14:.1f} s")


# ------------------------- 15. serving a trained checkpoint, and the drivers
PHASE15_REQUESTS = 64      # the serving CLI's workload (make_workload, seed 7)
PHASE15_KERNELS = ("scoring", "intersect", "gather_fuse", "intersect_backward",
                   "gather_fuse_backward")


def _phase15_rank(rank: int, world: int, work: str) -> None:
    """One of phase 15 (b)'s gloo ranks on the card (spawned): restores each
    single-device checkpoint onto ``data=2`` fsdp (entity rows padded to
    the mesh) and serves (a)'s recorded compositions through
    ``serve_batch(ctx=)``; pickles its answers, its entity block's check
    and its launches to ``work/p15.r<rank>.pkl``."""
    import datetime
    import pickle

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{work}/pg15", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    from repro_torch.core import PooledExecutor
    from repro_torch.distributed import make_execution_context
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import read_answers, restore_params, serve_batch
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.semantic import SemanticCache, SemanticStore
    from repro_torch.training.checkpoint import list_checkpoints

    t0 = time.perf_counter()
    ctx = make_execution_context(f"data={world}", profile="fsdp", device=dev, backend="gloo")
    out = {}
    for family, ck, answers in inp["cases"]:
        sem = family == "gqe+sem"
        model = make_model(family.split("+")[0], ModelConfig(
            semantic_dim=SEM_DIM if sem else 0, entity_pad=world), device=dev)
        store = SemanticStore(inp["sem_dir"]) if sem else None
        cache = SemanticCache(store, SEM_BUDGET, device=dev, ctx=ctx) if sem else None
        gen = torch.Generator(device=dev).manual_seed(0)
        params = model.init_params(gen, FB15K[0], FB15K[1], semantic_cache=cache, ctx=ctx)
        before = params["entity"].clone()
        step = restore_params(ck, model, params, ctx=ctx, sem_cache=cache)
        with np.load(os.path.join(list_checkpoints(ck)[-1], "arrays.npz")) as z:
            ent = z["params/entity"]
        n = before.shape[0]
        axes = ctx.row_axes("entity", model.full_shapes["entity"])
        lo = ctx.mesh.index(axes) * n if axes else 0
        real = max(min(FB15K[0] - lo, n), 0)
        block = params["entity"].cpu().numpy()
        own_block = bool(np.array_equal(block[:real], ent[lo:lo + real])
                         and torch.equal(params["entity"][real:], before[real:]))
        ex = PooledExecutor(model, b_max=256, device=dev, ctx=ctx)
        for name in PHASE15_KERNELS:
            getattr(kops, name).launches = 0
        got = []
        for rec in read_answers(answers):
            res, _ = serve_batch(model, params, ex, rec.queries, top_k=TOP_K, sem_cache=cache,
                                 ctx=ctx, sem_rows_fn=store.read_rows if sem else None)
            got.append([{k: r[k] for k in ("top_entities", "scores")} for r in res[:rec.n_real]])
        torch.cuda.synchronize()
        out[family] = {"step": step, "answers": got, "own_block": own_block,
                       "block": tuple(params["entity"].shape),
                       "full": model.full_shapes["entity"], "ckpt_rows": int(ent.shape[0]),
                       "launches": {k: getattr(kops, k).launches for k in PHASE15_KERNELS}}
        del model, params, cache, ex
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    with open(os.path.join(work, f"p15.r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _phase15_spawn(world: int, work: str) -> list:
    import pickle

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    pc = mp.start_processes(_phase15_rank, args=(world, work), nprocs=world, join=False,
                            start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while not pc.join(timeout=1):
            if time.monotonic() > deadline:
                fail(f"phase 15: the {world}-rank gloo spawn ran past {RANK_TIMEOUT_S} s")
    except ProcessException as e:
        fail(f"phase 15: a gloo rank failed: {e}")
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    out = []
    for r in range(world):
        with open(os.path.join(work, f"p15.r{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def phase15(torch, dev, main_path, obs_work, sem_dir, card) -> None:
    """Serving a trained checkpoint, and the example drivers (module
    docstring, 15). ``obs_work`` holds phase 8's checkpoints (a short
    training run at the same width writes them where it does not). The
    launches of the serving and training paths are added to
    ``main_path``."""
    import contextlib
    import io
    import pickle

    from repro_torch.core import PooledExecutor
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import e2e as e2e_cli
    from repro_torch.launch import lm_zoo as lm_zoo_cli
    from repro_torch.launch import semantic_fusion as fusion_cli
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.serve import read_answers, serve_batch
    from repro_torch.models import ModelConfig, make_model, params_from_numpy
    from repro_torch.semantic import SemanticCache, SemanticStore
    from repro_torch.serving import check_against_offline
    from repro_torch.training.checkpoint import load_checkpoint

    t15 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_serve_")
    atexit.register(shutil.rmtree, work, ignore_errors=True)
    added = collections.Counter()

    def counts() -> dict:
        return {name: getattr(kops, name).launches for name in PHASE15_KERNELS}

    def zero() -> None:
        for name in PHASE15_KERNELS:
            getattr(kops, name).launches = 0

    def run(label: str, fn, argv, show=()) -> tuple:
        """One CLI's ``main(argv)`` in this process: (its output, the launches
        it made). Echoes the lines that start with ``show``."""
        buf = io.StringIO()
        zero()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                fn(argv)
        except (Exception, SystemExit) as e:
            print(buf.getvalue())
            fail(f"phase 15 {label}: {fn.__module__} raised {e!r}")
        torch.cuda.synchronize()
        launched = counts()
        print(f"phase 15 {label}: python -m {fn.__module__} {' '.join(argv)} "
              f"({time.perf_counter() - t0:.1f} s) | launches {launched}")
        for line in buf.getvalue().splitlines():
            if line.startswith(show):
                print(f"  | {line[:300]}")
        torch.cuda.empty_cache()
        return buf.getvalue(), launched

    def add(launched, keys) -> None:
        for name, key in keys.items():
            added[key] += launched[name]

    # Phase 8's checkpoints at full width, or a short run writing them.
    ckpts = {}
    sem_args = ["--semantic-store", sem_dir]
    for family, argv in (("betae", ["--model", "betae"]),
                         ("gqe+sem", ["--model", "gqe"] + sem_args + ["--semantic-dim",
                                                                     str(SEM_DIM)])):
        name = "ckpt_betae" if family == "betae" else "ckpt_sem"
        ck = os.path.join(str(obs_work), name) if obs_work else os.path.join(work, name)
        if load_checkpoint(ck) is None:
            run(f"checkpoint {family}", train_cli.main,
                argv + ["--dim", str(ModelConfig().dim), "--steps", "4", "--log-every", "0",
                        "--eval-queries", "16", "--ckpt-dir", ck], show=("trained",))
        ckpts[family] = ck
    store = SemanticStore(sem_dir)

    # (a) Single device: the CLI's answers replayed through serve_batch on
    # the checkpoint's params, read here apart from the CLI's restore.
    serve_args = ["--requests", str(PHASE15_REQUESTS), "--top-k", str(TOP_K)]
    show = ("loaded checkpoint", "[closed]", "engine:", "replica ", "semantic cache")
    oracle, answers = {}, {}
    for family in ("betae", "gqe+sem"):
        sem = family == "gqe+sem"
        argv = (["--model", "gqe"] + sem_args + ["--semantic-budget-rows", str(SEM_BUDGET)]
                if sem else ["--model", "betae"]) + serve_args
        answers[family] = os.path.join(work, f"{family}.jsonl")
        out, launched = run(f"(a) {family}", serve_cli.main,
                            argv + ["--ckpt-dir", ckpts[family], "--answers", answers[family]],
                            show)
        arrays = load_checkpoint(ckpts[family])
        if f"loaded checkpoint step={arrays[0]}" not in out:
            fail(f"phase 15 (a) {family}: the CLI did not load step {arrays[0]}")
        trained = {k[len("params/"):]: v for k, v in arrays[1].items()
                   if k.startswith("params/") and k not in ("params/sem_cache",
                                                            "params/sem_slot")}
        model = make_model(family.split("+")[0], ModelConfig(semantic_dim=SEM_DIM if sem else 0),
                           device=dev)
        cache = None
        if sem:
            cache = SemanticCache(store, SEM_BUDGET, device=dev)
            params = model.init_params(torch.Generator(device=dev).manual_seed(1), FB15K[0],
                                       FB15K[1], semantic_cache=cache)
            with torch.no_grad():
                for k, v in trained.items():
                    params[k].copy_(torch.from_numpy(v))
        else:
            params = params_from_numpy(model, trained, n_entities=FB15K[0])
        ex = PooledExecutor(model, b_max=256, device=dev)

        def offline(qs, model=model, params=params, ex=ex, cache=cache):
            return serve_batch(model, params, ex, qs, top_k=TOP_K, device=dev,
                               sem_cache=cache,
                               sem_rows_fn=store.read_rows if cache is not None else None)[0]

        oracle[family] = offline
        log = read_answers(answers[family])
        try:
            checked = check_against_offline(log, offline)
        except AssertionError as e:
            fail(f"phase 15 (a) {family}: the CLI's answers are not serve_batch's on the "
                 f"checkpoint's params: {e}")
        need = ("scoring", "gather_fuse") if sem else ("intersect",)
        if not all(launched[k] for k in need):
            fail(f"phase 15 (a) {family}: launches {launched}, want {need} launched")
        add(launched, {"scoring": "scoring[l1][out-of-core]",
                       "gather_fuse": "gather_fuse[out-of-core]"} if sem
            else {"intersect": "intersect"})
        rand = os.path.join(work, f"{family}.random.jsonl")
        run(f"(a) {family}, random weights", serve_cli.main, argv + ["--answers", rand])
        if ([r.results for r in read_answers(rand)] == [r.results for r in log]):
            fail(f"phase 15 (a) {family}: the checkpoint's answers are the random weights'")
        print(f"  {checked} answers of {len(log)} micro-batches bitwise serve_batch on the "
              f"checkpoint (step {arrays[0]}) read apart; other answers than the random "
              f"weights' | {card}")
    tier = os.path.join(work, "tier.jsonl")
    _, launched = run("(a) betae, --replicas 2", serve_cli.main,
                      ["--model", "betae", "--replicas", "2", "--ckpt-dir", ckpts["betae"],
                       "--answers", tier] + serve_args, show)
    try:
        checked = check_against_offline(read_answers(tier), oracle["betae"])
    except AssertionError as e:
        fail(f"phase 15 (a) --replicas 2: not serve_batch's on the checkpoint: {e}")
    if not launched["intersect"]:
        fail(f"phase 15 (a) --replicas 2: launches {launched}")
    add(launched, {"intersect": "intersect"})
    print(f"  {checked} answers of both replicas bitwise serve_batch on the checkpoint")

    # (b) Under a mesh: one NCCL rank through torchrun, bitwise single-device;
    # two gloo ranks on the card restoring with the rows padded.
    nccl = os.path.join(work, "nccl.jsonl")
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "1", "-m", "repro_torch.launch.serve", "--mesh", "data=1", "--profile", "fsdp",
            "--model", "betae", "--ckpt-dir", ckpts["betae"], "--answers", nccl] + serve_args
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=RANK_TIMEOUT_S,
                          cwd=work, env={**os.environ, "PYTHONPATH": str(SRC)})
    if proc.returncode != 0 or "loaded checkpoint step=" not in proc.stdout:
        fail(f"phase 15 (b): torchrun rc {proc.returncode}\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    try:
        checked = check_against_offline(read_answers(nccl), oracle["betae"])
    except AssertionError as e:
        fail(f"phase 15 (b) one NCCL rank: not single-device serve_batch's: {e}")
    print(f"phase 15 (b): {' '.join(argv[1:])} ({time.perf_counter() - t0:.1f} s): {checked} "
          f"answers bitwise single-device serve_batch on the checkpoint")
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump({"sem_dir": sem_dir, "cases": [(fam, ckpts[fam], answers[fam])
                                                   for fam in ("betae", "gqe+sem")]}, f)
    gloo = _phase15_spawn(2, work)
    for family in ("betae", "gqe+sem"):
        r0, r1 = gloo[0][family], gloo[1][family]
        want = [res for rec in read_answers(answers[family]) for res in rec.results]
        got = [res for batch in r0["answers"] for res in batch]
        worst, topk = _answers_gap(got, want, r0["full"][1])
        if r0["answers"] != r1["answers"] or not (worst <= 1.0 and topk) or len(got) != len(want):
            fail(f"phase 15 (b) gloo {family}: ranks equal {r0['answers'] == r1['answers']}, "
                 f"against (a) {worst:.3g} of the tolerance, top-k {topk}")
        for r, o in enumerate((r0, r1)):
            if (not o["own_block"] or o["block"][0] * 2 != o["full"][0]
                    or o["full"][0] != FB15K[0] + 1 or o["ckpt_rows"] != FB15K[0]):
                fail(f"phase 15 (b) gloo {family}: rank {r} holds {o['block']} of {o['full']} "
                     f"from {o['ckpt_rows']} checkpoint rows (own block {o['own_block']})")
        need = ("scoring", "gather_fuse") if family == "gqe+sem" else ("intersect",)
        if not all(o["launches"][k] for o in (r0, r1) for k in need):
            fail(f"phase 15 (b) gloo {family}: launches {[o['launches'] for o in (r0, r1)]}")
        for o in (r0, r1):
            add(o["launches"], {"scoring": "scoring[l1][out-of-core]",
                                "gather_fuse": "gather_fuse[out-of-core]"}
                if family == "gqe+sem" else {"intersect": "intersect"})
        print(f"phase 15 (b) two gloo ranks on the card, data=2 fsdp, {family}: the "
              f"{r0['ckpt_rows']}-row checkpoint restored as blocks {r0['block']} of "
              f"{r0['full']} (the padding row the rank's own), answers bitwise equal on both "
              f"ranks and within {worst:.3g} of the tolerance of (a)'s, top-k by the gap rule "
              f"| launches {[o['launches'] for o in (r0, r1)]}")
    print(f"phase 15 (b) two gloo ranks in {gloo[0]['seconds']:.1f} s")

    # (c) The example drivers on the card.
    out, launched = run("(c) e2e", e2e_cli.main, ["--dim", "400"],
                        show=("graph", "---", "resumed", "eval"))
    if "resumed at step 60" not in out or not all(
            launched[k] for k in ("intersect", "intersect_backward", "gather_fuse",
                                  "gather_fuse_backward")):
        fail(f"phase 15 (c) e2e: launches {launched}\n{out[-2000:]}")
    add(launched, {"intersect": "intersect[training]", "intersect_backward": "intersect_backward",
                   "gather_fuse": "gather_fuse[training]",
                   "gather_fuse_backward": "gather_fuse_backward"})
    out, launched = run("(c) semantic_fusion", fusion_cli.main, [],
                        show=("H_sem", "decoupled", "kernel =="))
    if "kernel == model fusion: True" not in out or not launched["gather_fuse_backward"]:
        fail(f"phase 15 (c) semantic_fusion: launches {launched}\n{out[-2000:]}")
    out, _ = run("(c) lm_zoo", lm_zoo_cli.main, ["--arch", "qwen2-0.5b"],
                 show=("==", "  train step", "  prefill"))
    if "finite=True" not in out:
        fail(f"phase 15 (c) lm_zoo: {out[-2000:]}")

    # (d) Every kernel of these paths launched, added to the kernels line.
    for key, n in added.items():
        if key in main_path:
            k_n, counter = main_path[key]
            main_path[key] = (k_n + n, counter)
    print(f"checkpoint serving and drivers: launches {dict(added)} added to the kernels line "
          f"| phase 15 in {time.perf_counter() - t15:.1f} s | {card}")


if __name__ == "__main__":
    main()
