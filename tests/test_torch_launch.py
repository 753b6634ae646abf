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


@pytest.mark.parametrize("argv,slice_", [
    (["--mesh", "data=2"], "slice 9"), (["--profile", "fsdp"], "slice 9"),
    (["--autotune"], "slice 7"), (["--autotune-cache", "tiles.json"], "slice 7")])
def test_train_cli_later_slices_raise(argv, slice_, capsys):
    with pytest.raises(NotImplementedError, match=slice_):
        _train(["--steps", "1"] + argv, capsys)


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
    with pytest.raises(NotImplementedError, match="slice 7"):
        env.main(["--autotune-cache", "tiles.json", "--report"])
    with pytest.raises(SystemExit):
        env.main(["--host-devices", "8", "--report"])   # an XLA-only option
