"""The readers of the serving engine's spans and counters from inside a
batch (``queue_wait_ms``, ``plan_ms``, ``encode_device_ms``,
``score_device_ms``, ``respond_ms``, ``gc_ms``) on the tiny cells, on the
CPU: a window served as the harness serves it, handed to each reader with a
stand-in for the card's trace; nothing read without the card's trace or
from a program that records none of them; and the device lane read where
the program writes one."""
from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import devtrace, harness, traffic
from perfbench.graph import load_or_generate
from perfbench.tests.conftest import ROOT, TINY_CELLS

NEW = ("queue_wait_ms", "plan_ms", "encode_device_ms", "score_device_ms", "respond_ms",
       "gc_ms")
SEED = 2**31 + 29


@pytest.fixture(autouse=True)
def _tracer_off():
    from repro_torch.obs.trace import TRACER
    yield
    TRACER.enable(profiler_annotations=False)
    TRACER.disable()


def _served(root, name, seconds=0.6, seed=SEED) -> harness.Run:
    """One traced window of a tiny cell, as ``harness.run_cell`` serves it,
    as the ``Run`` its readers get; ``trace`` stands in for the card's."""
    from repro_torch.obs.trace import TRACER

    cell = harness.load_cell(root, name)
    graph = load_or_generate(cell.config["graph"], None)
    pool = traffic.make_pool(graph, cell.mix, seed)
    weights = cell.family.make_weights(cell.config, graph.n_entities, graph.n_relations,
                                       seed, "cpu")
    system = cell.system.build(cell, graph, weights, pool, "cpu")
    try:
        system.warm_up()
        cell.loop.run(system.submit, traffic.Feed(len(pool), seed + 7), cell.mix,
                      requests=cell.mix["warmup_requests"])
        system.reset_counters()
        TRACER.enable(profiler_annotations=False)
        window = cell.loop.run(system.submit, traffic.Feed(len(pool), seed), cell.mix,
                               seconds=seconds)
        TRACER.disable()
        return harness.Run(cell, seed, 0.0, window, system.stats(), pool,
                           trace=devtrace.DeviceTrace(0, 1, []),
                           spans=devtrace.host_spans(TRACER.events(), TRACER.epoch))
    finally:
        system.close()


def test_each_new_metric_names_the_three_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    layers = {m["layer"] for m in bench["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["workloads"] == ["serve.betae.mix", "serve.betae-sem.mix",
                                  "serve.betae.paths"]
        assert m["moves"] == "serve_qps" and m["unit"] == "ms" and m["better"] == "lower"
        assert m["layer"] in layers - {None}
    assert [m["name"] for m in bench["per_layer"]][-len(NEW):] == list(NEW)


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_the_readers_on_a_tiny_cell(tiny_root, cell):
    run = _served(tiny_root, cell)
    c = run.cell
    got = {m: c.reader(m).read(run) for m in NEW}
    # The card's lane is not on the CPU.
    assert got["encode_device_ms"] is None and got["score_device_ms"] is None
    lat = np.mean([(s.t_done - s.t_submit) * 1e3 for s in run.answered()])
    assert 0 < got["queue_wait_ms"] < lat
    assert 0 < got["plan_ms"] < run.span_ms("encode")
    assert 0 < got["respond_ms"] < lat
    assert got["gc_ms"] >= 0
    # A request waits, is served in its batch, then answered in its respond.
    batch = run.span_ms("batch")
    assert got["queue_wait_ms"] + batch <= lat + got["respond_ms"] + 1.0


def test_nothing_is_read_without_the_cards_trace_or_from_an_older_program(tiny_root):
    run = _served(tiny_root, "tiny.mix", seconds=0.3)
    c = run.cell
    cpu = harness.Run(**{**run.__dict__, "trace": None})
    assert all(c.reader(m).read(cpu) is None for m in NEW)
    # A program without the spans and the counter: none of them is read.
    old = harness.Run(**{**run.__dict__,
                         "spans": [s for s in run.spans if s[0] not in ("plan", "respond", "gc")],
                         "stats": {k: v for k, v in run.stats.items() if k != "queue_wait_ms"}})
    assert all(c.reader(m).read(old) is None for m in NEW)


def test_gc_ms_is_the_collections_a_batch():
    reader = harness.load_cell(ROOT, "serve.betae.mix").reader("gc_ms")
    ms = 1_000_000
    spans = [("batch", 0, 10 * ms), ("gc", 2 * ms, 5 * ms), ("respond", 9 * ms, 10 * ms),
             ("batch", 20 * ms, 30 * ms), ("respond", 29 * ms, 30 * ms),
             ("gc", 29 * ms, 30 * ms)]
    run = SimpleNamespace(trace=object(), spans=spans)
    assert reader.read(run) == pytest.approx(2.0)
    run.spans = [s for s in spans if s[0] != "gc"]
    assert reader.read(run) == 0.0


class _Event:
    now_ms = 0.0

    def __init__(self, enable_timing=False):
        self.t_ms = None

    def record(self, stream=None):
        self.t_ms = _Event.now_ms

    def query(self):
        return True

    def elapsed_time(self, end):
        return end.t_ms - self.t_ms


def test_the_device_readers_read_the_device_lane(monkeypatch):
    """The program's device windows, driven by stand-in CUDA events: the
    readers give the mean ``encode.device`` and ``score.device`` spans of
    the lane, and nothing from another lane."""
    from repro_torch.obs.trace import TRACER

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    TRACER.enable(profiler_annotations=False)
    for lane, marks in (("serving device", (0.0, 1.0, 5.0)),
                        ("serving device", (10.0, 13.0, 15.0)),
                        ("serving batcher", (20.0, 30.0, 40.0))):
        TRACER.device_open(lane, "cuda")
        for phase, at in zip(("plan", "encode", "score"), marks):
            _Event.now_ms = at
            TRACER.device_mark(phase)
        TRACER.device_close()
    TRACER.disable()
    cell = harness.load_cell(ROOT, "serve.betae.mix")
    run = SimpleNamespace(trace=object())
    assert cell.reader("encode_device_ms").read(run) == pytest.approx(2.0)
    assert cell.reader("score_device_ms").read(run) == pytest.approx(3.0)
    assert cell.reader("encode_device_ms").read(SimpleNamespace(trace=None)) is None
