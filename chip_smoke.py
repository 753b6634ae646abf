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
   run) beside each kernel's bound.
4. Serve: BetaE, GQE and ComplEx at full width (dim 400) on a synthetic graph
   with FB15k's Table 4 shape, through ``ServingEngine.submit``: one warm-up
   window, then five timed closed-loop windows of fresh requests (QPS, p50
   and p99 over all of them, and the spread between windows). Every result
   has top-k finite scores, every recorded micro-batch replays identically
   through ``serve_batch``, the first batch agrees with the plain path on the
   CPU, and the kernels' launch counts (zeroed just before the timed windows)
   show the path went through them.
5. A ``{"kernels": [...]}`` line with each kernel's numbers at the shape the
   serving path gave it most often.
6. The last line: ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"

# NVIDIA H100 SXM data sheet (dense): HBM bandwidth, fp32 on CUDA cores, bf16
# on tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
FB15K = (14_951, 1_345, 483_142)  # Table 4: entities, relations, train triples
WARMUP_PER_PATTERN = 8     # warm-up window: requests of each of the 14 patterns
WINDOWS = 5                # timed closed-loop windows, fresh requests in each
WINDOW_PER_PATTERN = 32    # requests of each pattern in one timed window
TOP_K = 10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(torch, fn, flush, reps: int = 25) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), with
    the L2 cache flushed before each run. Zeroing the 512 MB flush buffer
    takes the card longer than the host needs to enqueue a run, so the card
    never waits on the host between the events and the host's launch cost
    stays out of the time."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


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

    from repro_torch.core import TEMPLATES, OpType, PooledExecutor
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import ModelConfig, make_model, params_from_numpy
    from repro_torch.models.base import glorot
    from repro_torch.sampling import OnlineSampler
    from repro_torch.serving import (ServingConfig, ServingEngine,
                                     check_against_offline, latency_summary,
                                     run_closed_loop)

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
    flush = torch.empty(512 * 2**20 // 4, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    fp = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def bound(nbytes: float, flops: float, dtype: str):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def measure_scoring(mode: str, B: int, N: int, d: int, dtype: str) -> dict:
        q = torch.randn((B, d), generator=gen, device=dev).to(fp[dtype])
        e = torch.randn((N, d), generator=gen, device=dev).to(fp[dtype])
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
        return {
            "max_abs_err": float((got - want).abs().max()),
            "ms": time_ms(torch, lambda: kops.scoring(q, e, 12.0, mode), flush),
            "plain_ms": time_ms(torch, lambda: kops.scoring_ref(q, e, 12.0, mode), flush),
            "library_ms": library and time_ms(torch, library, flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"B": B, "N": N, "d": d}, "dtype": dtype,
        }

    def measure_intersect(n: int, k: int, d: int, hd: int, dtype: str) -> dict:
        # BetaE-like values: Beta parameters from the entity-state map, MLP
        # weights from the model's own initializer.
        x = torch.nn.functional.softplus(
            2.0 * torch.randn((n, k, d), generator=gen, device=dev) / 20.0) + 0.05
        x = x.to(fp[dtype])
        w1 = glorot((d, hd), gen, dev)
        b1 = 0.1 * torch.randn((hd,), generator=gen, device=dev)
        w2 = glorot((hd, 1), gen, dev)
        b2 = torch.zeros((1,), device=dev)
        got = kops.intersect(x, w1, b1, w2, b2)
        want = kops.intersect_ref(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        tol = 1e-5 if dtype == "float32" else 5e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        elt = x.element_size()
        nbytes = (n * k * d + n * d) * elt + (d * hd + 2 * hd + 1) * 4
        flops = n * k * (2 * d * hd + 4 * hd + 2 * d)
        b_ms, b_by = bound(nbytes, flops, dtype)
        return {
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": time_ms(torch, lambda: kops.intersect(x, w1, b1, w2, b2), flush),
            "plain_ms": time_ms(torch, lambda: kops.intersect_ref(x, w1, b1, w2, b2), flush),
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"n": n, "k": k, "d": d, "hd": hd}, "dtype": dtype,
        }

    def show(name: str, r: dict) -> None:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {name} {r['shape']} {r['dtype']}: max_abs_err "
              f"{r['max_abs_err']:.3g}, kernel_ms {r['ms']:.4f}, plain_ms "
              f"{r['plain_ms']:.4f}, library_ms {lib}, bound_ms "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")

    E, R, T = FB15K
    print("kernels against their plain versions:")
    for dtype in ("float32", "bfloat16"):
        for mode in ("l1", "dot"):
            for B, N, d in ((1, E, 400), (16, E, 400), (5, 333, 96)):
                show(f"scoring[{mode}]", measure_scoring(mode, B, N, d, dtype))
        for n, k, d, hd in ((16, 2, 800, 800), (16, 3, 800, 800),
                            (256, 2, 800, 800), (256, 3, 800, 800),
                            (100, 3, 64, 128)):
            show("intersect", measure_intersect(n, k, d, hd, dtype))

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
    for family in ("betae", "gqe", "complex"):
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

        shapes = collections.Counter()
        for rec in engine.batch_log:
            if family == "betae":
                for op, card, pn in executor.prepare(rec.queries).meta:
                    if op in (int(OpType.INTERSECT), int(OpType.UNION)):
                        shapes[(pn, card)] += 1
            else:
                shapes[len(rec.queries)] += 1
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
              f"kernel shapes {dict(shapes)}")
        need = "intersect" if family == "betae" else "scoring"
        if launches[need] == 0:
            fail(f"{family}: the {need} kernel was never launched")
        # One launch per intersect/union op (BetaE) or per micro-batch's
        # score_all (GQE, ComplEx) of the timed windows, and no other.
        if launches[need] != sum(shapes.values()):
            fail(f"{family}: {launches[need]} {need} launches for "
                 f"{sum(shapes.values())} calls in the recorded batches")
        key = "intersect" if family == "betae" else f"scoring[{model.score_mode}]"
        main_path[key] = (launches[need], shapes)
        del engine, executor, model, params
        torch.cuda.empty_cache()

    # ------------------------------------------------- 5. the kernels line
    entries = []
    for key, (launches, shapes) in main_path.items():
        shape = shapes.most_common(1)[0][0]
        if key == "intersect":
            n, k = shape
            r = measure_intersect(n, k, 2 * cfg.dim, cfg.dim * cfg.hidden_mult,
                                  "float32")
            src, replaces = "intersect.cu", "src/repro/kernels/intersect.py:50"
        else:
            mode = key[len("scoring["):-1]
            r = measure_scoring(mode, shape, E, cfg.dim, "float32")
            src, replaces = "scoring.cu", "src/repro/kernels/scoring.py:48"
        show(f"{key} (main path)", r)
        entries.append({"name": key, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{src}",
                        "replaces": replaces, "launches": launches, **r})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
