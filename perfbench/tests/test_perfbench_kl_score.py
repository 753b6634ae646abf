"""The ``kl_score_roofline`` reader on synthetic runs: nothing read without
the card's trace or from a program without the ``betae_kl`` entry, the share
from the recorded calls' shapes and the launches' times, and a refusal where
launches and recorded calls disagree."""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from perfbench import devtrace, harness
from perfbench.tests.conftest import ROOT

CELLS = ["serve.betae.mix", "serve.betae-sem.mix", "serve.betae.paths"]
# One micro-batch of 16 states [16, 800] scored against FB15k's 14,951 rows.
CALL = ([((16, 800), 4), ((14951, 400), 4)], {"gamma": None})


def _reader():
    import repro_torch.kernels.ops  # noqa: F401  (the program, as a traced run has it)
    return harness.load_cell(ROOT, "serve.betae.mix").reader("kl_score_roofline")


def _run(launch_us, calls, name="void (anonymous namespace)::betae_kl_kernel<1>(...)"):
    launches = [(name, a, a + int(launch_us * 1e3)) for a in range(0, 1_000_000 * len(calls),
                                                                   1_000_000)]
    return SimpleNamespace(trace=devtrace.DeviceTrace(0, 10_000_000, launches),
                           calls={"betae_kl": calls})


def test_the_metric_names_the_three_cells_and_its_layer():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}["kl_score_roofline"]
    assert m["workloads"] == CELLS and m["moves"] == "serve_qps"
    assert m["layer"] == "scoring and top-k" and m["unit"] == "%" and m["better"] == "higher"
    assert m["source"] == "device_trace"
    assert [x["name"] for x in bench["per_layer"]][-1] == "kl_score_roofline"


def test_share_from_the_calls_and_launches():
    reader = _reader()
    assert reader.HOOK == "betae_kl"
    B, N, d = 16, 14951, 400
    least = max(((B * 2 * d + N * d) * 4 + B * N * 4) / 3.35e12, 4 * d * B * N / 67e12)
    share = reader.read(_run(100.0, [CALL, CALL]))
    assert share == pytest.approx(100.0 * least / 100e-6, rel=1e-6)
    assert 5.0 < share < 10.0          # 7.4 us of the bytes over 100 us


def test_nothing_is_read_without_the_cards_trace_or_a_launch():
    reader = _reader()
    assert reader.read(SimpleNamespace(trace=None, calls={})) is None
    empty = ([((0, 800), 4), ((14951, 400), 4)], {})
    assert reader.read(_run(0.0, [])) is None
    run = _run(0.0, [])
    run.calls = {"betae_kl": [empty]}   # a call that launches nothing
    assert reader.read(run) is None


def test_a_launch_no_recorded_call_matches_raises():
    reader = _reader()
    with pytest.raises(RuntimeError, match="2 launches"):
        reader.read(SimpleNamespace(trace=_run(50.0, [CALL, CALL]).trace, calls={}))
    with pytest.raises(RuntimeError, match="1 launches"):
        reader.read(SimpleNamespace(trace=_run(50.0, [CALL]).trace, calls={"betae_kl": [CALL] * 2}))


def test_a_program_without_the_entry_hooks_nothing(monkeypatch):
    import repro_torch.kernels.ops as ops

    monkeypatch.delattr(ops, "betae_kl")
    reader = harness.load_cell(ROOT, "serve.betae.mix").reader("kl_score_roofline")
    assert reader.HOOK is None
    # The eager KL's launches are other kernels: nothing to read, no error.
    eager = [("elementwise_kernel_CUDAFunctor_add_", 0, 1000)]
    assert reader.read(SimpleNamespace(trace=devtrace.DeviceTrace(0, 10_000, eager),
                                       calls={})) is None
