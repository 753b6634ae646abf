"""The harness on the CPU at a tiny size: cells found by name, a cell added
as files alone, a whole run through the port's plain versions, the check
of the answers against the reference, its control and planted faults, and
the rules on imports and devices."""
from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness, judge
from perfbench.tests.conftest import ROOT, TINY_CELLS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _run(root, cell, seed=2**31 + 17, seconds=0.6, trace=False, **kw):
    return harness.run_cell(harness.load_cell(root, cell), seed, seconds, trace, "cpu",
                            time.perf_counter(), **kw)


def test_benchmark_json_keeps_the_contracts_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = ([c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", ["serve.betae.mix", "serve.betae-sem.mix", "serve.betae.paths"])
def test_cells_are_found_from_their_files_by_name(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.config["model"] == "betae" and callable(c.family.Reference)
    assert c.mix["clients"] == 64 and c.mix["pool"] == 8192
    for trace in (False, True):
        for m in c.metrics(trace):
            assert callable(c.reader(m["name"]).read)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", TINY_CELLS)
def test_tiny_cell_runs_end_to_end(tiny_root, cell, trace):
    out = _run(tiny_root, cell, trace=trace)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    want = ({"serve_p95_ms", "batch_fill", "encode_ms", "score_ms", "select_ms"} if trace
            else {"serve_qps", "setup_s"})
    assert set(out["metrics"]) == want       # the card's metrics need a card
    assert all(v["value"] > 0 for v in out["metrics"].values())
    if trace:
        assert out["metrics"]["batch_fill"]["value"] <= 16


def test_a_cell_added_as_files_alone_runs(tiny_root, tmp_path):
    root = tmp_path / "added"
    shutil.copytree(tiny_root, root)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "tiny.json").read_text())
    cfg["gamma"] = 10.0
    (pb / "configs" / "tiny-g10.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "tiny-mix14.json").read_text())
    # A mix that sets another ServingConfig field and names a load
    # generator of its own.
    mix.update(patterns={"2u": 1, "up": 2}, max_batch=4, queue_depth=64, loop="half")
    (pb / "traffic" / "unions.json").write_text(json.dumps(mix))
    (pb / "loops" / "half.py").write_text(
        "from perfbench.loops import closed\n"
        "def run(submit, feed, mix, seconds=0.0, requests=0):\n"
        "    return closed.run(submit, feed, {**mix, 'clients': mix['clients'] // 2},\n"
        "                      seconds=seconds, requests=requests)\n")
    (pb / "metrics" / "union_share.py").write_text(
        "def read(run):\n"
        "    a = run.answered()\n"
        "    return 100.0 * sum(run.pool[s.index].pattern == 'up' for s in a) / len(a)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-g10", "source": "tests", "reduced": [],
                             "file": "perfbench/configs/tiny-g10.json", "why": "tests"})
    bench["workloads"].append({"name": "tiny-g10.unions", "config": "tiny-g10",
                               "traffic": "unions", "chips": 1, "why": "tests"})
    bench["per_layer"].append({"name": "union_share", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "traffic",
                               "moves": "serve_qps", "workloads": ["tiny-g10.unions"]})
    for m in bench["per_layer"]:
        if m["name"] == "batch_fill":
            m["workloads"].append("tiny-g10.unions")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run(root, "tiny-g10.unions", trace=True)
    assert out["correct"], out["checks"]
    assert 50.0 < out["metrics"]["union_share"]["value"] < 85.0
    assert out["metrics"]["batch_fill"]["value"] <= 4
    cell = harness.load_cell(root, "tiny-g10.unions")
    assert cell.loop.__name__.endswith("half") and cell.mix["system"] == "engine"


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_reference_agrees_with_the_port_and_its_control_fails(tiny_root, cell):
    out = _run(tiny_root, cell, control=True)
    assert out["correct"], out["checks"]
    limits = harness.load_cell(tiny_root, cell).config["check_limits"]
    for k, lim in limits.items():
        assert out["checks"][k]["value"] <= lim
    # The reference with every product in TF32 in the program's place.
    assert any(out["control"][k] > lim for k, lim in limits.items()), out["control"]


def _answer_altered(monkeypatch):
    import repro_torch.serving.engine as engine
    real = engine.topk_desc
    # The best entity dropped: each answer's ids move up one rank.
    monkeypatch.setattr(engine, "topk_desc", lambda s, k: real(s, k + 1)[:, 1:])


def _half_the_batch(monkeypatch):
    import repro_torch.serving.engine as engine
    real = engine.CachedScorer.__call__

    def half(self, params, q, n_entities=None):
        s = real(self, params, q[: max(q.shape[0] // 2, 1)], n_entities)
        return s.repeat(2, 1)[: q.shape[0]]
    monkeypatch.setattr(engine.CachedScorer, "__call__", half)


def _state_unchanged(monkeypatch):
    from repro_torch.models.betae import BetaE
    # A projection that hands its input state on unchanged.
    monkeypatch.setattr(BetaE, "project", lambda self, params, x, rel_ids: x)


@pytest.mark.parametrize("fault", [_answer_altered, _half_the_batch, _state_unchanged])
def test_a_fault_under_the_timed_path_makes_the_run_incorrect(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(tiny_root, "tiny.mix")
    assert out["correct"] is False, out["checks"]


def test_no_module_imports_jax_or_the_jax_package():
    found = []
    for path in (ROOT / "perfbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                    else [])
            for m in mods:
                top = m.split(".")[0]
                if top in harness.FORBIDDEN:
                    found.append((str(path), m))
                # The references and the yardstick use nothing of the program.
                if top == "repro_torch" and path.parent.name in ("models", "metrics"):
                    found.append((str(path), m))
    assert not found


def test_forbidden_modules_are_matched_by_whole_top_level_name(monkeypatch):
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    assert "repro" not in harness.forbidden_modules()   # repro_torch is not repro
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_modules() == ["repro"]


def _cli(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "serve.betae.mix",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_prints_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _cli(ROOT)
    assert p.returncode != 0 and not p.stdout.strip()
    assert "needs 1 CUDA device" in p.stderr


def test_cli_prints_no_result_without_the_program(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _cli(tmp_path)
    assert p.returncode != 0 and not p.stdout.strip()


def test_judge_reads_gaps_beyond_rounding():
    ref = torch.tensor([[3.0, 2.0, 1.0, 0.5]], dtype=torch.float64)
    assert judge.gaps(ref, [([0, 1], [3.0004, 1.9996])]) == {"score_gap": 0.0,
                                                              "rank_gap": 0.0}
    g = judge.gaps(ref, [([0, 2], [3.0, 1.0])])
    assert g["rank_gap"] == 1.0 and g["score_gap"] == 0.0
    assert judge.gaps(ref, [([0, 1], [3.0, 2.01])])["score_gap"] == pytest.approx(0.0095)
    assert judge.malformed({"top_entities": [1, 1], "scores": [0.0, 0.0]}, 2, 4)
    assert not judge.malformed({"top_entities": [1, 3], "scores": [0.0, 0.0]}, 2, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["serve.betae.mix", "serve.betae-sem.mix", "serve.betae.paths"])
def test_control_fails_at_the_cells_size_on_the_card(gpu, cell):
    c = harness.load_cell(ROOT, cell)
    out = harness.run_cell(c, 2**31 + 101, 2.0, False, gpu, time.perf_counter(),
                           cache_dir=ROOT / "build" / "perfbench", control=True)
    assert out["correct"], out["checks"]
    assert any(out["control"][k] > lim for k, lim in c.config["check_limits"].items())


def test_a_roofline_refuses_launches_that_no_recorded_call_matches():
    from types import SimpleNamespace

    from perfbench import devtrace
    reader = harness.load_cell(ROOT, "serve.betae.mix").reader("intersect_roofline")
    launches = [("intersect_kernel<float>", a, a + 10_000) for a in (0, 50_000)]
    run = SimpleNamespace(trace=devtrace.DeviceTrace(0, 100_000, launches), calls={})
    with pytest.raises(RuntimeError, match="2 launches"):
        reader.read(run)                        # the kernel reached another way
    call = ([((8, 2, 800), 4), ((800, 1600), 4)], {})
    run.calls = {"intersect": [call]}
    with pytest.raises(RuntimeError, match="1 calls"):
        reader.read(run)
    run.calls = {"intersect": [call, call]}
    assert 10.0 < reader.read(run) < 20.0       # 1.55 us of 10 us
    run.trace, run.calls = devtrace.DeviceTrace(0, 100_000, []), {}
    assert reader.read(run) is None             # nothing launched, nothing to read
