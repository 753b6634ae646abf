"""Inside a served batch, on the CPU: the serving engine's ``plan``,
``respond`` and ``gc`` spans, its queue-wait counter, the tracer's device
windows (driven by stand-in CUDA events, since this machine has no card)
and its clock link, and the union of device intervals that
``launch.profile`` reads a busy share from. The card's own check of the
device lane against ``torch.profiler`` is in ``tests/test_torch_gpu.py``."""
import gc
import time

import numpy as np
import pytest
import torch

from repro_torch.obs import TRACER, validate_trace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every test leaves the process-wide tracer disabled and empty."""
    yield
    TRACER.enable(profiler_annotations=False)
    TRACER.disable()


@pytest.fixture(scope="module")
def kg():
    from repro_torch.data import generate_synthetic_kg
    return generate_synthetic_kg(200, 10, 2400, seed=0)


def _engine(kg, max_batch=4, max_wait_ms=5.0, **kw):
    from repro_torch.core import PooledExecutor
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.serving import ServingConfig, ServingEngine

    model = make_model("betae", ModelConfig(dim=8), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0), kg.n_entities,
                               kg.n_relations)
    return ServingEngine(model, params, device="cpu",
                         executor=PooledExecutor(model, b_max=64, device="cpu"),
                         cfg=ServingConfig(max_batch=max_batch, max_wait_ms=max_wait_ms),
                         **kw)


def _workload(kg, n, seed):
    from repro_torch.serving import make_workload
    return make_workload(kg, n, seed=seed)


def _serve_traced(engine, queries, callback=None):
    TRACER.enable(profiler_annotations=False)
    futures = engine.submit_many(queries)
    if callback is not None:
        futures[0].add_done_callback(callback)
    for f in futures:
        f.result(timeout=60)
    engine.close()
    TRACER.disable()
    return TRACER.to_json()


def _lanes(obj):
    return {e["tid"]: e["args"]["name"] for e in obj["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"}


def _spans(obj, name, lane=None):
    lanes = _lanes(obj)
    return [e for e in obj["traceEvents"] if e["ph"] == "X" and e["name"] == name
            and (lane is None or lanes[e["tid"]] == lane)]


def _inside(child, parent):
    return (parent["tid"] == child["tid"] and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 1e-3)


def test_plan_nests_in_encode_on_the_batcher_lane(kg):
    engine = _engine(kg)
    queries = _workload(kg, 12, seed=3)
    obj = _serve_traced(engine, queries + queries)
    validate_trace(obj)
    plans = _spans(obj, "plan", "serving batcher")
    encodes = _spans(obj, "encode", "serving batcher")
    assert len(plans) == len(encodes) == engine.stats()["batches"]
    for p in plans:
        assert any(_inside(p, e) for e in encodes)
        assert p["args"]["scheduled"] in (0, 1)
        assert p["args"]["plan_hit"] in ("exact", "canonical", "none")
    # The first pass compiles every plan; the replay finds each batch's plan.
    hits = [p["args"]["plan_hit"] for p in plans]
    assert hits[0] == "none" and plans[0]["args"]["scheduled"] == 1
    assert "exact" in hits[len(hits) // 2:]


def test_plan_args_follow_the_caches(kg):
    """Outside the engine (no batch window, no device mark), the executor's
    ``plan`` span reads each outcome off the caches: a fresh batch runs the
    scheduler, the same batch hits exactly, a permutation hits canonically."""
    from repro_torch.core import PooledExecutor
    from repro_torch.models import ModelConfig, make_model

    model = make_model("betae", ModelConfig(dim=8), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0), kg.n_entities,
                               kg.n_relations)
    ex = PooledExecutor(model, b_max=64, device="cpu")
    qs = _workload(kg, 6, seed=4)
    TRACER.enable(profiler_annotations=False)
    for batch in (qs, qs, qs[::-1]):
        ex.encode(params, batch)
    TRACER.disable()
    args = [e["args"] for e in _spans(TRACER.to_json(), "plan")]
    assert args == [{"scheduled": 1, "plan_hit": "none"},
                    {"scheduled": 0, "plan_hit": "exact"},
                    {"scheduled": 0, "plan_hit": "canonical"}]


def test_a_respond_span_follows_each_batch(kg):
    engine = _engine(kg)
    obj = _serve_traced(engine, _workload(kg, 10, seed=5))
    batches = sorted(_spans(obj, "batch", "serving batcher"), key=lambda e: e["ts"])
    responds = sorted(_spans(obj, "respond", "serving batcher"), key=lambda e: e["ts"])
    assert len(responds) == len(batches) == engine.stats()["batches"]
    for b, r in zip(batches, responds):
        assert r["ts"] >= b["ts"] + b["dur"] - 1e-3
        assert r["args"]["n"] == b["args"]["n"]
    assert sum(r["args"]["n"] for r in responds) == 10


def test_gc_spans_land_only_on_the_batcher_lane(kg):
    """A collection the batcher thread runs (here from a caller's
    done-callback, inside ``respond``) is a ``gc`` span on its lane; one run
    on the caller's thread while the tracer is on records none."""
    engine = _engine(kg)
    obj = _serve_traced(engine, _workload(kg, 6, seed=6),
                        callback=lambda f: gc.collect())
    spans = _spans(obj, "gc")
    assert spans and all(_lanes(obj)[e["tid"]] == "serving batcher" for e in spans)
    full = [e for e in spans if e["args"]["generation"] == 2]
    assert full and all(e["args"]["collected"] >= 0 for e in full)
    responds = _spans(obj, "respond")
    assert any(_inside(g, r) for g in full for r in responds)
    assert engine._gc_hook is None   # removed at close

    TRACER.enable(profiler_annotations=False)
    engine = _engine(kg)
    try:
        gc.collect()
        assert not _spans(TRACER.to_json(), "gc")
    finally:
        engine.close()


def test_queue_wait_counts_each_request_once(kg):
    engine = _engine(kg, max_batch=4, max_wait_ms=20.0)
    try:
        for f in engine.submit_many(_workload(kg, 11, seed=7)):
            f.result(timeout=60)
        st = engine.stats()
        qw, lat = st["queue_wait_ms"], st["latency_ms"]
        assert set(qw) == set(lat)
        assert qw["n"] == lat["n"] == qw["window_n"] == 11
        assert 0 <= qw["p50"] <= lat["p50"] and qw["mean"] <= lat["mean"]
        assert qw["max"] <= lat["max"]
        engine.reset_counters()
        assert "queue_wait_ms" not in engine.stats()
        for f in engine.submit_many(_workload(kg, 3, seed=8)):
            f.result(timeout=60)
        assert engine.stats()["queue_wait_ms"]["n"] == 3
    finally:
        engine.close()


class _Clock:
    """Stand-in for the card's clock: each event records the time the test
    sets."""
    now_ms = 0.0


class _FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t_ms = None

    def record(self, stream=None):
        self.t_ms = _Clock.now_ms

    def query(self):
        return self.t_ms is not None

    def elapsed_time(self, end):
        return end.t_ms - self.t_ms


@pytest.fixture
def fake_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    _FakeEvent.made = 0
    _Clock.now_ms = 0.0
    return _Clock


def test_device_window_places_phases_back_from_the_anchor(fake_events):
    TRACER.enable(profiler_annotations=False)
    TRACER.device_mark("plan")                         # no window: dropped
    assert _FakeEvent.made == 0
    TRACER.device_open("serving device", torch.device("cuda"))
    for phase, at_ms in (("plan", 1.0), ("encode", 3.5), ("score", 9.0)):
        fake_events.now_ms = at_ms
        TRACER.device_mark(phase)
    fake_events.now_ms = 10.0
    t_close = time.perf_counter()
    TRACER.device_close()
    TRACER.device_mark("plan")                         # closed: dropped
    assert _FakeEvent.made == 4
    obj = TRACER.to_json()
    validate_trace(obj)
    lane = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in lane] == ["encode.device", "score.device"]
    assert {_lanes(obj)[e["tid"]] for e in lane} == {"serving device"}
    enc, score = lane
    assert enc["dur"] == pytest.approx(2500.0) and score["dur"] == pytest.approx(5500.0)
    assert score["ts"] == pytest.approx(enc["ts"] + enc["dur"])
    # The anchor (10 ms on the card) is the close's host time.
    end_s = TRACER.epoch + (score["ts"] + score["dur"]) * 1e-6
    assert abs(end_s + 1e-3 - t_close) < 5e-3


def test_device_window_needs_a_cuda_device_the_tracer_and_one_generation(fake_events):
    TRACER.enable(profiler_annotations=False)
    TRACER.device_open("serving device", torch.device("cpu"))
    TRACER.device_mark("encode")
    TRACER.device_close()
    TRACER.disable()
    TRACER.device_open("serving device", "cuda")
    TRACER.device_mark("encode")
    TRACER.device_close()
    assert _FakeEvent.made == 0
    TRACER.enable(profiler_annotations=False)
    TRACER.device_open("serving device", "cuda")
    TRACER.device_mark("encode")
    TRACER.enable(profiler_annotations=False)          # a new trace: the window is stale
    TRACER.device_mark("score")
    TRACER.device_close()
    assert _FakeEvent.made == 1
    assert not [e for e in TRACER.to_json()["traceEvents"] if e["ph"] == "X"]


def test_the_engine_on_the_cpu_makes_no_device_lane_and_no_cuda_call(kg, monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("a CUDA event on the CPU")
    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    engine = _engine(kg)
    obj = _serve_traced(engine, _workload(kg, 8, seed=9))
    assert not [n for n in _lanes(obj).values() if n.endswith("device")]
    assert not [e for e in obj["traceEvents"] if e["name"].endswith(".device")]
    assert _spans(obj, "plan") and _spans(obj, "respond")


def test_nothing_is_recorded_while_the_tracer_is_off(kg, fake_events):
    """Tracer off, on a (stand-in) CUDA device: no span, counter or CUDA
    event, collections and done-callbacks included."""
    TRACER.enable(profiler_annotations=False)
    TRACER.disable()
    engine = _engine(kg)
    engine.device = torch.device("cuda")     # the device windows' test only
    try:
        futures = engine.submit_many(_workload(kg, 8, seed=10))
        futures[0].add_done_callback(lambda f: gc.collect())
        for f in futures:
            f.result(timeout=60)
    finally:
        engine.close()
    assert TRACER._events == [] and _FakeEvent.made == 0


def test_clock_sync_is_written_and_validates(tmp_path):
    from repro_torch.obs import SpanTracer

    tr = SpanTracer()
    assert tr.clock_sync is None
    lo = time.time_ns()
    tr.enable(profiler_annotations=False)
    hi = time.time_ns()
    with tr.span("work"):
        pass
    path = tmp_path / "t.json"
    tr.write(str(path))
    import json
    obj = json.loads(path.read_text())
    validate_trace(obj)
    sync = [e for e in obj["traceEvents"] if e["ph"] == "M" and e["name"] == "clock_sync"]
    assert len(sync) == 1
    perf_ns, unix_ns = sync[0]["args"]["perf_counter_ns"], sync[0]["args"]["unix_ns"]
    assert (perf_ns, unix_ns) == tr.clock_sync and lo <= unix_ns <= hi
    # ts 0 is the pair's perf_counter reading.
    assert tr.epoch == pytest.approx(perf_ns * 1e-9, abs=1e-9)
    work = next(e for e in obj["traceEvents"] if e["name"] == "work")
    assert unix_ns + work["ts"] * 1e3 <= time.time_ns()


@pytest.mark.parametrize("intervals,want", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 15)], 15),                     # two streams overlapping
    ([(0, 10), (2, 4)], 10),                      # one inside another
    ([(20, 30), (0, 10), (10, 12)], 22),          # touching, out of order
    ([(0, 10), (5, 15), (40, 50), (45, 48)], 25),
])
def test_profile_busy_share_is_the_union_of_intervals(intervals, want):
    from repro_torch.launch.profile import busy_ns
    assert busy_ns(intervals) == want
    assert busy_ns(iter(intervals)) == want
