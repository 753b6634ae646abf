"""Where one serving micro-batch spends its time on the GPU.

For BetaE, GQE and ComplEx at full width on FB15k's Table 4 shape, serves
warm micro-batches of 16 (the engine's ``max_batch``) through
``serve_batch``'s phases (pooled encode, all-entity scoring, host top-k) and
prints, per family:

* the wall time of each phase (host clock, ``torch.cuda.synchronize()`` at
  each phase boundary), median over 10 batches;
* the card's busy time per batch (sum of kernel and copy times from a
  ``torch.profiler`` trace of the same batches) and its share of the wall
  time — how far the host holds the card back;
* the kernels that take the most device time.

    PYTHONPATH=src python -m repro_torch.launch.profile
"""
from __future__ import annotations

import json
import statistics
import time

import torch

from repro_torch.core import PooledExecutor
from repro_torch.data import load_dataset
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, make_model
from repro_torch.serving import make_workload, scorer_for, topk_desc

FAMILIES = ("betae", "gqe", "complex")
BATCH = 16     # queries per micro-batch
REPS = 10      # batches timed, then traced
TOP = 12       # kernels listed by device time


def _device_us(evt) -> float:
    # ``self_device_time_total`` (PyTorch >= 2.4) was ``self_cuda_time_total``.
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _on_device(evt) -> bool:
    """Kernels and copies; operator events on the CPU also carry the device
    time of the kernels they launched, which must not count twice."""
    return evt.device_type != torch.autograd.DeviceType.CPU


def profile_family(family: str, kg, device) -> dict:
    model = make_model(family, ModelConfig(), device=device)
    params = model.init_params(torch.Generator(device=device).manual_seed(1),
                               kg.n_entities, kg.n_relations)
    executor = PooledExecutor(model, b_max=256, device=device)
    scorer = scorer_for(model)
    batches = [make_workload(kg, BATCH, seed=100 + i) for i in range(REPS)]

    def serve(queries, phases=None):
        t0 = time.perf_counter()
        states = executor.encode(params, queries)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scores = scorer(params, states).cpu().numpy()
        t2 = time.perf_counter()
        topk_desc(scores, 10)
        t3 = time.perf_counter()
        if phases is not None:
            phases.append((t1 - t0, t2 - t1, t3 - t2))

    for q in batches:   # warm: plans, closures, kernel library, allocator
        serve(q)
    phases = []
    for q in batches:
        serve(q, phases)
    walls = [sum(p) * 1e3 for p in phases]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for q in batches:
            serve(q)
    events = [e for e in prof.key_averages() if _on_device(e)]
    device_ms = sum(_device_us(e) for e in events) / 1e3 / len(batches)
    wall_ms = statistics.median(walls)
    print(f"{family} on {torch.cuda.get_device_name(device)}: "
          f"{BATCH} queries per batch, {len(batches)} batches")
    for name, i in (("encode", 0), ("score", 1), ("top-k (host)", 2)):
        print(f"  {name:13s} wall {statistics.median(p[i] for p in phases) * 1e3:8.3f} ms")
    print(f"  device busy {device_ms:.3f} ms of {wall_ms:.3f} ms wall per batch "
          f"({device_ms / wall_ms:.1%})")
    for e in sorted(events, key=_device_us, reverse=True)[:TOP]:
        if _device_us(e) > 0:
            print(f"    {_device_us(e) / 1e3 / len(batches):8.4f} ms/batch "
                  f"{e.count // len(batches):5d} calls/batch  {e.key[:80]}")
    return {"model": family, "batch": BATCH, "wall_ms_per_batch": wall_ms,
            "device_ms_per_batch": device_ms, "device_busy": device_ms / wall_ms}


def main() -> None:
    device = resolve_device(None)
    kg, _, _ = load_dataset("FB15k", reduced=False, seed=0)
    for family in FAMILIES:
        print(json.dumps(profile_family(family, kg, device)))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
