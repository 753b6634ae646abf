"""A tiny benchmark root for CPU tests: the real ``perfbench/`` tree copied
under ``tmp_path`` with a small configuration (600 entities, dim 16) of
each family and a small traffic mix, and the three cells' metrics
extended to the tiny cells."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_GRAPH = {"n_entities": 600, "n_relations": 40, "n_triples": 8000, "seed": 0,
              "hub_exponent": 0.8}
TINY_CELLS = ("tiny.mix", "tiny-sem.mix", "tiny.paths")


def make_root(dest: Path) -> Path:
    """``dest`` holding BENCHMARK.json and perfbench/, with the tiny cells."""
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = dest / "perfbench"
    for name, src in (("tiny", "betae-fb15k"), ("tiny-sem", "betae-sem-fb15k")):
        cfg = json.loads((pb / "configs" / f"{src}.json").read_text())
        cfg.update(dim=16, graph=TINY_GRAPH)
        if cfg["semantic_dim"]:
            cfg.update(semantic_dim=32, semantic_proj_dim=8)
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "tests", "reduced": ["dim"],
                                 "file": f"perfbench/configs/{name}.json", "why": "tests"})
    for mix in ("mix14", "paths"):
        t = json.loads((pb / "traffic" / f"{mix}.json").read_text())
        t.update(pool=256, clients=8, warmup_requests=32, check_requests=48)
        (pb / "traffic" / f"tiny-{mix}.json").write_text(json.dumps(t))
    for cell, cfg, mix in zip(TINY_CELLS, ("tiny", "tiny-sem", "tiny"),
                              ("tiny-mix14", "tiny-mix14", "tiny-paths")):
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": mix,
                                   "chips": 1, "why": "tests"})
    real = {w["name"]: w for w in bench["workloads"]}
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [c for c, r in zip(TINY_CELLS, (
                "serve.betae.mix", "serve.betae-sem.mix", "serve.betae.paths"))
                if r in m["workloads"] and r in real]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def gpu():
    """Skips a test where no CUDA device is present (decided here, never at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
