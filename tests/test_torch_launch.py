"""The port's launchers on the CPU: the training CLI (``launch/train.py``) in
its modes, with a trace and metrics read back by ``obs.report``, resuming a
checkpoint the JAX package's CLI wrote; the serving CLI's ``--trace`` and
``--metrics``; and ``launch/env.py``'s plan against the JAX package's, less
the XLA and JAX entries. Small sizes: the reduced FB15k stand-in, dim 8,
batch 16."""
import json
import sys

import jax  # noqa: F401  (on the CPU, before the JAX package's modules)
import numpy as np
import pytest
import torch

from repro_torch.obs import read_jsonl, validate_trace

torch.set_num_threads(1)

SMALL = ["--reduced", "--device", "cpu", "--dim", "8", "--batch-size", "16",
         "--negatives", "4", "--eval-queries", "8", "--log-every", "0"]


def _train(argv, capsys):
    from repro_torch.launch.train import main

    main(SMALL + argv)
    return capsys.readouterr().out


def _eval_line(out):
    line = next(l for l in out.splitlines() if l.startswith("eval: "))
    metrics = json.loads(line[len("eval: "):])
    assert np.isfinite(metrics["mrr"])
    return metrics


# ------------------------------------------------------------ launch.train
@pytest.mark.parametrize("mode,argv,want", [
    ("sync", ["--model", "gqe"], "trained 3 steps [sync]"),
    ("pipelined", ["--model", "betae", "--pipeline"], "trained 3 steps [pipelined]"),
    ("query_level", ["--model", "gqe", "--pipeline", "--executor", "query_level"],
     "note: --pipeline requires --executor pooled; ran the sync path"),
    ("materialized", ["--model", "gqe", "--materialized-rows", "64", "--no-cse"],
     "materialized rows: hit rate"),
    ("live_writes", ["--model", "gqe", "--live-writes", "2"], "live-write smoke: graph version 0 -> 2"),
])
def test_train_cli_on_cpu(mode, argv, want, capsys):
    out = _train(argv + ["--steps", "3"], capsys)
    assert want in out
    if mode == "query_level":
        assert "trained 3 steps [sync]" in out and "CSE off (query-level baseline)" in out
    if mode == "materialized":
        assert "plan compiler: CSE off" in out
    _eval_line(out)


def test_train_cli_semantic_store_builds_then_reuses(tmp_path, capsys):
    """``--semantic-store`` builds the store on first use, reuses it after,
    and stages the hot set on the scheduler thread with ``--pipeline``."""
    argv = ["--model", "gqe", "--steps", "2", "--pipeline", "--semantic-store",
            str(tmp_path / "sem"), "--semantic-dim", "16", "--semantic-budget-rows", "256"]
    out = _train(argv, capsys)
    assert "semantic store: built 600x16 fp32" in out
    assert "semantic cache: 256 device rows" in out
    assert "(0 synchronous mid-step reads)" in out
    _eval_line(out)
    out = _train(argv, capsys)
    assert "semantic store: reusing" in out


def test_train_cli_trace_and_metrics(tmp_path, capsys):
    """``--trace``/``--metrics`` on a pipelined run: a valid trace with the
    pipeline's lanes and spans, one step record a step and a registry
    snapshot last, and a report with all three sections."""
    from repro_torch.obs.report import main as report

    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    _train(["--model", "betae", "--pipeline", "--steps", "4", "--trace", trace,
            "--metrics", metrics], capsys)
    s = validate_trace(json.load(open(trace)))
    assert {"main dispatch", "pipeline scheduler"} <= set(s["lanes"])
    assert {"pipeline_wait", "dispatch", "retire", "sample", "schedule", "transfer",
            "prepared_q_depth"} <= set(s["names"])
    recs = read_jsonl(metrics)
    assert [r["kind"] for r in recs] == ["step"] * 4 + ["snapshot"]
    assert all(r["mode"] == "pipelined" and 0 <= r["bubble_frac"] <= 1 for r in recs[:4])
    report(["--trace", trace, "--metrics", metrics])
    out = capsys.readouterr().out
    assert "lane [main dispatch]" in out and "pipeline bubble" in out and "caches:" in out


def test_train_cli_resumes_a_checkpoint_of_the_jax_cli(tmp_path, monkeypatch, capsys):
    """A checkpoint the JAX package's training CLI writes (its reduced
    graph, the same model and widths) is where the port's CLI resumes."""
    from repro.launch import train as j_train
    from repro_torch.training.checkpoint import load_checkpoint

    ckpt = str(tmp_path / "ck")
    monkeypatch.setattr(sys, "argv", [
        "train", "--model", "gqe", "--dim", "8", "--batch-size", "16", "--negatives", "4",
        "--steps", "2", "--eval-queries", "8", "--log-every", "0", "--ckpt-dir", ckpt])
    j_train.main()
    capsys.readouterr()
    step, _, _ = load_checkpoint(ckpt)
    assert step == 2
    out = _train(["--model", "gqe", "--steps", "1", "--ckpt-dir", ckpt], capsys)
    assert "resumed from checkpoint at step 2" in out
    assert load_checkpoint(ckpt)[0] == 3


def test_train_cli_mesh_under_a_one_rank_group(tmp_path, capsys):
    """``--mesh data=1 --profile fsdp`` in a process that already holds a
    one-rank gloo group: the reference's context and entity-table lines,
    a loss line a step (the mesh samples inline from the seeded sampler, so
    two runs agree), the rank's metrics file, and eval."""
    from torch_parity import one_rank_group

    argv = ["--model", "gqe", "--steps", "3", "--log-every", "1", "--mesh", "data=1",
            "--profile", "fsdp"]
    with one_rank_group(tmp_path):
        out = _train(argv + ["--metrics", str(tmp_path / "m.jsonl")], capsys)
        again = _train(argv, capsys)
    assert "execution context: mesh(data=1, model=1) profile=fsdp (1 devices, dp=1)" in out
    assert "MB/device" in out and "entity table:" in out

    def losses(text):
        return [l.split(" q/s")[0] for l in text.splitlines() if l.startswith("step ")]

    assert len(losses(out)) == 3 and losses(out) == losses(again)
    assert [r["step"] for r in read_jsonl(str(tmp_path / "m.rank0.jsonl"))
            if r["kind"] == "step"] == [1, 2, 3]
    _eval_line(out)


@pytest.mark.parametrize("argv,need", [(["--mesh", "data=2"], 2),
                                       (["--mesh", "data=2,model=2", "--profile", "fsdp"], 4)])
def test_train_cli_mesh_raises_naming_torchrun(argv, need, tmp_path, capsys):
    """A mesh whose product is not the group's world size names the size
    and ``torchrun``; so does ``--mesh`` with no group and no launcher."""
    from torch_parity import one_rank_group

    with one_rank_group(tmp_path):
        with pytest.raises(ValueError, match=f"world size {need}.*torchrun --nproc-per-node {need}"):
            _train(["--steps", "1"] + argv, capsys)
    with pytest.raises(ValueError, match="torchrun"):
        _train(["--steps", "1"] + argv, capsys)


@pytest.fixture
def process_tuner():
    """The port's process tuner, restored after a CLI replaced it."""
    from repro_torch.kernels import autotune as kat

    prev = kat.set_tuner(None)
    yield kat
    kat.set_tuner(prev)


@pytest.mark.parametrize("model", ["betae", "gqe"])
def test_train_cli_autotune_writes_the_cache_then_sweeps_nothing(model, tmp_path, capsys,
                                                                 process_tuner):
    """``--autotune --autotune-cache F``: the sweep runs before the trainer
    exists and writes F; a second run loads F and runs 0 sweeps."""
    cache = str(tmp_path / "tiles.json")
    argv = ["--model", model, "--steps", "1", "--autotune", "--autotune-cache", cache]
    out = _train(argv, capsys)
    line = next(l for l in out.splitlines() if l.startswith("autotune: "))
    n_sweeps = int(line.split()[1])
    assert n_sweeps > 0 and f"{n_sweeps} cached configs @ {cache}" in line
    entries = json.load(open(cache))["entries"]
    assert len(entries) == n_sweeps and all(k.endswith("|cpu") for k in entries)
    _eval_line(out)
    out = _train(argv, capsys)
    assert "autotune: 0 sweeps in" in out and f"{n_sweeps} cached configs" in out
    assert process_tuner.get_tuner().stats()["sweeps"] == 0
    out = _train(["--model", model, "--steps", "1", "--autotune-cache", cache], capsys)
    assert f"autotune: {n_sweeps} tuned configs loaded from {cache}" in out


def test_train_cli_autotune_tunes_the_scoring_bucket_of_its_graph(tmp_path, capsys,
                                                                   process_tuner):
    """``--autotune`` sweeps scoring at the graph's own entity count: the
    bucket the run's scoring launches hit."""
    from repro_torch.data import load_dataset

    at = process_tuner
    cache = str(tmp_path / "tiles.json")
    _train(["--model", "gqe", "--steps", "1", "--autotune", "--autotune-cache", cache],
           capsys)
    kg = load_dataset("FB15k", reduced=True)[0]
    entries = json.load(open(cache))["entries"]
    scoring = {k for k, e in entries.items() if e["op"] == "scoring"}
    assert scoring == {at.cache_key("scoring", at.scoring_bucket(16, kg.n_entities, 8),
                                    "float32", "cpu")}


def test_train_cli_autotune_without_a_cache_tunes_the_process_tuner(capsys, process_tuner):
    out = _train(["--model", "betae", "--steps", "1", "--autotune"], capsys)
    assert "autotune: " in out and " @ " not in out.split("autotune: ")[1].splitlines()[0]
    assert len(process_tuner.get_tuner()) > 0 and process_tuner.get_tuner().path is None


def test_train_cli_needs_a_gpu_unless_told_cpu(monkeypatch):
    from repro_torch.launch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--reduced", "--steps", "1"])


# ------------------------------------------------------------ launch.serve
def test_serve_cli_trace_and_metrics(tmp_path, capsys):
    """The single engine's timed replay, traced: every request's async span
    balanced, the client and batcher lanes, the batcher's spans; the
    metrics file a registry snapshot with the engine's counters."""
    from repro_torch.launch.serve import main
    from repro_torch.obs.report import main as report

    trace, metrics = str(tmp_path / "s.json"), str(tmp_path / "s.jsonl")
    main(["--model", "gqe", "--reduced", "--device", "cpu", "--dim", "8",
          "--requests", "32", "--max-wait-ms", "1000", "--trace", trace,
          "--metrics", metrics])
    obj = json.load(open(trace))
    s = validate_trace(obj)
    assert sum(e["ph"] == "b" and e["name"] == "request" for e in obj["traceEvents"]) == 32
    assert {"client 0", "serving batcher"} <= set(s["lanes"])
    assert {"request", "batch", "encode", "score", "select"} <= set(s["names"])
    (snap,) = read_jsonl(metrics)
    assert snap["kind"] == "snapshot" and snap["metrics"]["serving_completed"] >= 32
    capsys.readouterr()
    report(["--metrics", metrics])
    assert "cache{cache=encode}" in capsys.readouterr().out


def test_serve_cli_traces_the_replica_tier(tmp_path, capsys):
    from repro_torch.launch.serve import main

    trace, metrics = str(tmp_path / "r.json"), str(tmp_path / "r.jsonl")
    main(["--model", "gqe", "--reduced", "--device", "cpu", "--dim", "8",
          "--requests", "48", "--replicas", "2", "--tenants", "gold:high,bronze:low",
          "--priority-mix", "gold=0.25,bronze=0.75", "--trace", trace,
          "--metrics", metrics])
    obj = json.load(open(trace))
    s = validate_trace(obj)
    assert {"tenant gold", "tenant bronze", "replica 0 batcher",
            "replica 1 batcher"} <= set(s["lanes"])
    routes = [e for e in obj["traceEvents"] if e["ph"] == "X" and e["name"] == "route"]
    assert len(routes) == 48 and {e["args"]["tenant"] for e in routes} == {"gold", "bronze"}
    assert read_jsonl(metrics)[0]["metrics"]["router_routed"] >= 48
    assert "trace: wrote" in capsys.readouterr().out


def test_serve_cli_loads_the_autotune_cache_and_tunes_nothing(tmp_path, capsys,
                                                              process_tuner):
    from repro_torch.launch.serve import main

    cache = str(tmp_path / "tiles.json")
    _train(["--model", "betae", "--steps", "1", "--autotune", "--autotune-cache", cache],
           capsys)
    n = len(json.load(open(cache))["entries"])
    main(["--model", "betae", "--reduced", "--device", "cpu", "--dim", "8",
          "--requests", "32", "--autotune-cache", cache])
    assert f"autotune: {n} tuned configs loaded from {cache}" in capsys.readouterr().out
    stats = process_tuner.get_tuner().stats()
    assert stats["path"] == cache and stats["sweeps"] == 0 and stats["entries"] == n


# -------------------------------------------------------------- launch.env
XLA_AND_JAX = ("XLA_FLAGS", "JAX_ENABLE_X64", "JAX_DEFAULT_DTYPE_BITS",
               "TF_CPP_MIN_LOG_LEVEL")


@pytest.mark.parametrize("threads", [None, 4])
@pytest.mark.parametrize("tcmalloc", ["found", "missing", "off"])
@pytest.mark.parametrize("base", [{}, {"OMP_NUM_THREADS": "2", "LD_PRELOAD": "libjemalloc.so",
                                       "XLA_FLAGS": "--xla_dump_to=x"}])
def test_env_plan_matches_reference_less_xla_and_jax(threads, tcmalloc, base, monkeypatch):
    from repro.launch import env as j_env
    from repro_torch.launch import env as t_env

    lib = "/usr/lib/libtcmalloc.so.4" if tcmalloc == "found" else None
    for mod in (j_env, t_env):
        monkeypatch.setattr(mod, "find_tcmalloc", lambda: lib)
    want = j_env.build_plan(threads=threads, tcmalloc=tcmalloc != "off", base=base)
    got = t_env.build_plan(threads=threads, tcmalloc=tcmalloc != "off", base=base)
    assert got.env == {k: v for k, v in want.env.items() if k not in XLA_AND_JAX}
    assert got.notes == [n for n in want.notes if n[0] not in XLA_AND_JAX]
    kept = {k: v for k, v in base.items() if k in XLA_AND_JAX}  # never overwritten
    assert got.apply(base) == {**{k: v for k, v in want.apply(base).items()
                                  if k not in XLA_AND_JAX}, **kept}


def test_env_cli(capsys):
    from repro_torch.launch import env

    assert env.main(["--report"]) == 0
    assert "launch-env plan:" in capsys.readouterr().out
    assert env.main(["--threads", "2", "--dry-run", "--", "echo", "hi"]) == 0
    assert "would exec: echo hi" in capsys.readouterr().err
    assert env.main([]) == 2
    with pytest.raises(SystemExit):
        env.main(["--host-devices", "8", "--report"])   # an XLA-only option


@pytest.mark.parametrize("base", [{}, {"REPRO_TORCH_AUTOTUNE_CACHE": "old.json"}])
def test_env_cli_records_the_autotune_cache(base, monkeypatch, capsys):
    """``--autotune-cache F`` sets the port's variable (the process tuner's
    cache file) for the child, over a value the caller had, and the plan
    records it; the reference's variable is not touched."""
    from repro_torch.kernels.autotune import ENV_CACHE
    from repro_torch.launch import env

    assert env.AUTOTUNE_ENV == ENV_CACHE == "REPRO_TORCH_AUTOTUNE_CACHE"
    for k, v in base.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(env.os, "execvpe", lambda f, cmd, e: seen.update(e))
    assert env.main(["--autotune-cache", "tiles.json", "--", "echo", "hi"]) == 0
    assert seen[ENV_CACHE] == "tiles.json" and "REPRO_AUTOTUNE_CACHE" not in seen
    assert f"{ENV_CACHE:<18} 'tiles.json'" in capsys.readouterr().err
    assert env.main(["--autotune-cache", "tiles.json", "--report"]) == 0
    out = capsys.readouterr().out
    assert "REPRO_TORCH_AUTOTUNE_CACHE 'tiles.json'" in out
    assert f"current: autotune_cache = {base.get(ENV_CACHE, '')!r}" in out
