"""One run of one cell: set-up, the measured window, the check of the
answers, and the metrics.

Everything particular to a cell is found by name under the benchmark's
root (the checkout that holds ``BENCHMARK.json``):

* the cell's configuration: the ``file`` its ``configs`` entry names, and
  the model family it names, ``perfbench/models/<model>.py`` (the weights,
  the plain reference, the FLOPs a query needs), which the program serves
  as its own family of that name with the configuration's sizes;
* its traffic mix: ``perfbench/traffic/<traffic>.json``, which names the
  system under test (``perfbench/systems/<system>.py``, which builds it
  from the configuration and the mix) and the load generator
  (``perfbench/loops/<loop>.py``);
* each metric: ``perfbench/metrics/<name>.py``, whose ``read(run)`` returns
  the metric's value, or None where it finds nothing to read. A reader may
  name a kernel entry of ``repro_torch.kernels.ops`` in ``HOOK``: in a traced
  run the harness records the shapes of every call to it.

From the program the benchmark takes the system under test (built by the
system module), its counters, its host spans and the names of its kernels;
nothing else.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import re
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

from perfbench import devtrace, judge, traffic
from perfbench.graph import load_or_generate
from perfbench.loops import Served, Window

# Whole top-level module names that may not be loaded when a run ends.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# A traced run's window is at most this long: the profiler's trace of a
# longer one takes longer to read than it tells more.
TRACE_S = 4.0


def _load_file(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    root: Path
    bench: dict
    workload: dict
    config: dict               # the configuration file's contents
    mix: dict
    family: ModuleType
    system: ModuleType
    loop: ModuleType

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports in a run with or without trace."""
        group = self.bench["per_layer"] if trace else self.bench["end_to_end"]
        return [m for m in group if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str) -> ModuleType:
        path = self.root / "perfbench" / "metrics" / f"{metric}.py"
        return _load_file(path, "perfbench_metric_" + _ident(metric))


def load_cell(root: Path, name: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = work[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    mix = traffic.check_mix(json.loads(
        (root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text()))
    pb = root / "perfbench"
    family = _load_file(pb / "models" / f"{config['model']}.py",
                        "perfbench_model_" + _ident(config["model"]))
    system = _load_file(pb / "systems" / f"{mix['system']}.py",
                        "perfbench_system_" + _ident(mix["system"]))
    loop = _load_file(pb / "loops" / f"{mix['loop']}.py",
                      "perfbench_loop_" + _ident(mix["loop"]))
    return Cell(root, bench, w, config, mix, family, system, loop)


def _ident(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


@dataclasses.dataclass
class Run:
    """What a run hands to the metric readers."""
    cell: Cell
    seed: int
    setup_s: float
    window: Window
    stats: dict                          # the system's stats() after the window
    pool: list
    trace: Optional[devtrace.DeviceTrace] = None
    spans: List[tuple] = dataclasses.field(default_factory=list)   # (name, a_ns, b_ns)
    offset_ns: int = 0                   # host perf_counter_ns -> profiler clock
    calls: Dict[str, list] = dataclasses.field(default_factory=dict)

    def answered(self) -> List[Served]:
        return self.window.in_window()

    def span_ms(self, name: str) -> Optional[float]:
        d = [(b - a) * 1e-6 for n, a, b in self.spans if n == name]
        return float(np.mean(d)) if d else None


def _shape_tree(x):
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return (tuple(x.shape), x.element_size())
    if isinstance(x, dict):
        return {k: _shape_tree(v) for k, v in x.items()}
    return None


class _Hooks:
    """Records the shapes of each call to the named ``repro_torch.kernels.ops``
    entries while installed."""

    def __init__(self, names):
        import repro_torch.kernels.ops as ops
        self._ops = ops
        self.calls: Dict[str, list] = {n: [] for n in names}
        self._orig = {}
        for n in names:
            fn = getattr(ops, n)
            self._orig[n] = fn

            def wrapped(*a, _fn=fn, _log=self.calls[n], **kw):
                _log.append(([_shape_tree(v) for v in a],
                             {k: _shape_tree(v) for k, v in kw.items()}))
                return _fn(*a, **kw)
            setattr(ops, n, wrapped)

    def remove(self) -> None:
        for n, fn in self._orig.items():
            setattr(self._ops, n, fn)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, cache_dir: Optional[Path] = None,
             control: bool = False) -> dict:
    """One run; returns the result object that ``run.py`` prints.
    ``control`` (``calibrate.py``) also reads the control on the checked
    sample, under the result's ``control`` key."""
    import torch

    seed = seed % (1 << 63)
    cfg, mix, fam = cell.config, cell.mix, cell.family
    graph = load_or_generate(cfg["graph"], cache_dir)
    pool = traffic.make_pool(graph, mix, seed)
    weights = fam.make_weights(cfg, graph.n_entities, graph.n_relations, seed, device)
    system = cell.system.build(cell, graph, weights, pool, device)

    # Warm-up: what the system warms itself, then the load itself on this
    # seed's pool.
    system.warm_up()
    cell.loop.run(system.submit, traffic.Feed(len(pool), seed + 7), mix,
                  requests=mix["warmup_requests"])
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    system.reset_counters()
    # What set-up made is long-lived: out of the collector's way in the window.
    gc.collect()
    gc.freeze()

    hooks = prof = None
    if trace:
        from repro_torch.obs.trace import TRACER
        seconds = min(seconds, TRACE_S)
        names = sorted({getattr(cell.reader(m["name"]), "HOOK", None)
                        for m in cell.metrics(True)} - {None})
        hooks = _Hooks(names)
        TRACER.enable(profiler_annotations=False)
        if device.startswith("cuda"):
            prof = devtrace.Profiler()
            prof.start()
    setup_s = time.perf_counter() - t_start
    window = cell.loop.run(system.submit, traffic.Feed(len(pool), seed), mix,
                           seconds=seconds)
    run = Run(cell, seed, setup_s, window, {}, pool)
    if trace:
        run.trace = prof.stop() if prof is not None else None
        run.offset_ns = getattr(prof, "offset_ns", 0)
        hooks.remove()
        run.calls = hooks.calls
        TRACER.disable()
        run.spans = devtrace.host_spans(TRACER.events(), TRACER.epoch)
    run.stats = system.stats()
    peak = (max(torch.cuda.max_memory_allocated(i)
                for i in range(int(cell.workload["chips"])))
            if device.startswith("cuda") else 0)
    system.close()
    del system
    gc.unfreeze()
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    checks, correct, checked = check_answers(cell, weights, pool, window, seed)
    metrics = {}
    for m in cell.metrics(trace):
        v = cell.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    failed = sum(1 for s in window.served if s.result is None) + window.unanswered
    out = {"correct": correct, "attempted": len(window.served) + window.unanswered,
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if device.startswith("cuda") else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if device.startswith("cuda")
                               else "cpu"),
                      "count": int(cell.workload["chips"]),
                      "memory_peak_bytes": int(peak)}}
    if trace and run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s()
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = breakdown(run)
    if control and checked:
        with torch.no_grad():
            ctl = fam.reference_scores(fam.Reference(cfg, weights, "tf32"), checked)
            ref = fam.reference_scores(fam.Reference(cfg, weights, "float64"), checked)
            out["control"] = judge.gaps(ref, judge.control_answers(ctl, mix["top_k"]))
    out["checks"] = checks
    return out


def check_answers(cell: Cell, weights, pool, window: Window, seed: int):
    """(checks, correct, the checked queries): every answer well formed, none
    failed or missing, and a seeded sample within the configuration's limits
    of the reference."""
    cfg, mix, fam = cell.config, cell.mix, cell.family
    limits = cfg["check_limits"]
    n_ent = cfg["graph"]["n_entities"]
    answered = [s for s in window.served if s.result is not None]
    bad = sum(judge.malformed(s.result, mix["top_k"], n_ent) for s in answered)
    missing = len(window.served) - len(answered) + window.unanswered
    checks = {"failed_or_missing": {"value": missing, "limit": 0},
              "malformed": {"value": bad, "limit": 0}}
    checked = []
    if answered and not bad:
        import torch
        with torch.no_grad():
            ref = fam.Reference(cfg, weights, "float64")
            pick = judge.sample(len(answered), mix["check_requests"], seed)
            rows = [answered[i] for i in pick]
            checked = [pool[s.index] for s in rows]
            scores = fam.reference_scores(ref, checked)
            got = judge.gaps(scores, [(s.result["top_entities"], s.result["scores"])
                                      for s in rows])
        for k, v in got.items():
            checks[k] = {"value": v, "limit": limits[k]}
    correct = (bool(answered) and missing == 0 and bad == 0
               and all(checks[k]["value"] <= limits[k] for k in limits if k in checks)
               and all(k in checks for k in limits))
    return checks, correct, checked


def _short(name: str, width: int = 96) -> str:
    """A kernel's name without its return type and, where it is long, its
    template head with the functors it applies, cut to ``width``."""
    name = name[5:] if name.startswith("void ") else name
    if len(name) <= width:
        return name
    head = re.match(r"[\w:]*?(\w+)(?=<|\(|$)", name)
    head = head.group(1) if head else ""
    parts = []
    for ident in re.findall(r"[A-Za-z_]\w*", name):
        if ("Functor" in ident or "functor" in ident or ident.endswith("_kernel")
                or ident.endswith("Op")) and ident not in parts + [head]:
            parts.append(ident)
    short = f"{head}[{','.join(parts)}]"
    return short if parts and len(short) <= width else name[:width - 3] + "..."


def breakdown(run: Run) -> dict:
    ops = sorted(run.trace.by_name().items(), key=lambda kv: -kv[1][1])[:10]
    idle = devtrace.idle_by_span(run.trace, run.spans, run.offset_ns)
    return {"device_ops": [[_short(n), s] for n, (_, s) in ops],
            "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def check_lines(checks: dict) -> List[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e!r}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
