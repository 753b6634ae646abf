"""The port's telemetry layer (``repro_torch.obs``) on the CPU, held to the JAX
package's ``repro.obs``: the metrics registry (snapshots, delta, the one
registry-wide reset and its hooks), the span tracer (lanes, nesting across
threads, async request spans, truncation, the trace-event rules of
``validate_trace``), the JSONL sink, the trainers' step records, the
serving engine's, router's and store's spans, and ``obs.report``'s output.
Each of ``tests/test_obs.py``'s tests has its counterpart here, run on the
port; the parity tests run both packages on the same calls, and the
trainers on the same batches (dim 8–16, batch 8)."""
import contextlib
import io
import json
import queue
import threading
import time

import jax  # noqa: F401  (on the CPU, before the JAX package's modules)
import numpy as np
import pytest
import torch

import repro.obs as J
import repro_torch.obs as T
from repro_torch.obs import (Counter, Gauge, Histogram, MetricsSink, TRACER,
                             get_registry, read_jsonl, validate_trace)
from repro_torch.obs.registry import MetricsRegistry, metric_key
from repro_torch.obs.report import cache_tables, summarize_metrics, summarize_trace
from torch_parity import graphs

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every test leaves both process-wide tracers disabled and empty
    (``disable()`` keeps the events and ``enable()`` clears them), so a
    later test file in the same process, such as ``tests/test_obs.py``,
    finds none."""
    yield
    TRACER.enable(profiler_annotations=False)
    TRACER.disable()
    J.TRACER.enable(jax_annotations=False)
    J.TRACER.disable()


def _engine(dim=8, kg=None, **kw):
    """A GQE engine on the CPU; ``kg`` (a graph of its own) is also the live
    graph it follows."""
    from repro_torch.core import PooledExecutor
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.serving import ServingEngine

    if kg is not None:
        kw["kg"] = kg
    kg = graphs()[1] if kg is None else kg
    model = make_model("gqe", ModelConfig(dim=dim, gamma=6.0), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0), kg.n_entities,
                               kg.n_relations)
    return ServingEngine(model, params, device="cpu",
                         executor=PooledExecutor(model, b_max=64, device="cpu"), **kw)


def _trainer(dim=8, **cfg_kw):
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.training import AdamConfig, NGDBTrainer, TrainConfig

    cfg = TrainConfig(batch_size=8, n_negatives=4, b_max=64,
                      adam=AdamConfig(lr=1e-3), seed=0, **cfg_kw)
    return NGDBTrainer(make_model("gqe", ModelConfig(dim=dim, gamma=6.0), device="cpu"),
                       graphs()[1], cfg)


def _workload(n, seed):
    from repro_torch.serving import make_workload

    return make_workload(graphs()[1], n, seed=seed)


# ------------------------------------------------------------------ registry
def test_counter_is_int_like():
    c = Counter("x_hits")
    c += 2
    c.inc(3)
    assert c == 5 and c > 4 and c <= 5 and bool(c) and c.value == 5
    assert int(c) == 5 and float(c) == 5.0 and c / 2 == 2.5 and 10 / c == 2.0
    assert c + 1 == 6 and 1 + c == 6 and 10 - c == 5 and c - 1 == 4
    assert c * 2 == 10 and 2 * c == 10
    assert [0] * Counter("n") == []  # __index__
    d = Counter("y")
    d.inc(5)
    assert c == d and not (c < d)  # counter-vs-counter comparisons
    c.reset()
    assert c == 0 and not bool(c)


def test_gauge_reset_is_noop():
    g = Gauge("depth")
    g.set(7)
    g.reset()  # state, not history: reset must not fabricate depth 0
    assert g == 7


def test_histogram_window_and_summary():
    h = Histogram("lat", window=4)
    for v in (1.0, 2.0, 3.0, 4.0, 5.0):
        h.observe(v)
    assert h.count == 5 and h.sum == 15.0 and len(h) == 4
    assert h.window_values() == [2.0, 3.0, 4.0, 5.0]  # bounded window
    s = h.summary()
    assert s["count"] == 5 and s["window_n"] == 4 and s["window"] == 4
    assert s["p50"] == 3.5 and s["max"] == 5.0
    with pytest.raises(ValueError):
        Histogram("bad", window=0)


def test_metric_key_sorts_labels():
    g = MetricsRegistry().group("cache", cache="encode")
    c = g.counter("hits", b="2", a="1")
    assert metric_key(c) == "cache_hits{a=1,b=2,cache=encode}"


def test_snapshot_aggregates_same_key_instances():
    reg = MetricsRegistry()
    c1 = reg.group("serving").counter("batches")
    c2 = reg.group("serving").counter("batches")  # second engine
    c1.inc(3)
    c2.inc(4)
    snap = reg.snapshot()
    assert snap["serving_batches"] == 7
    c1.inc(10)
    assert reg.delta(snap)["serving_batches"] == 10


def test_snapshot_histogram_keys():
    reg = MetricsRegistry()
    h = reg.group("serving").histogram("latency_ms", window=8)
    h.observe(10.0)
    h.observe(20.0)
    snap = reg.snapshot()
    assert snap["serving_latency_ms_count"] == 2
    assert snap["serving_latency_ms_sum"] == 30.0
    assert snap["serving_latency_ms_window_n"] == 2
    assert snap["serving_latency_ms_p50"] == 15.0


def test_registry_holds_metrics_weakly():
    reg = MetricsRegistry()
    g = reg.group("tmp")
    c = g.counter("hits")
    c.inc()
    assert "tmp_hits" in reg.snapshot()
    del g, c  # component dies -> its metrics leave the snapshot
    assert "tmp_hits" not in reg.snapshot()


def test_group_reset_scopes_and_only():
    reg = MetricsRegistry()
    g = reg.group("eng")
    a, b = g.counter("a"), g.counter("b")
    a.inc(5)
    b.inc(5)
    g.reset(only=[a])
    assert a == 0 and b == 5
    g.reset()
    assert b == 0 and g.metrics() == [a, b]


def test_registry_reset_runs_hooks():
    reg = MetricsRegistry()
    fired = []

    class Comp:
        def hook(self):
            fired.append(1)

    comp = Comp()
    reg.on_reset(comp.hook)
    reg.reset()
    assert fired == [1]
    del comp  # weakly held: dead component's hook disappears
    reg.reset()
    assert fired == [1]


def _registry_script(mod, window):
    """One sequence of registry operations; every observable the JAX
    package's registry gives for it."""
    reg = mod.MetricsRegistry()
    g, h = reg.group("serving", replica="0"), reg.group("serving", replica="1")
    c1, c2 = g.counter("batches"), h.counter("batches")
    depth, size = g.gauge("queue_depth"), g.counter("flushes", kind="size")
    hist = g.histogram("latency_ms", window=window)
    c1.inc(3)
    c2 += 4
    depth.set(7)
    size.inc()
    for v in (1.0, 2.5, 4.0, 8.0, 16.0):
        hist.observe(v)
    out = {"arith": [c1 + 1, 1 + c1, c1 - 1, 10 - c1, c1 / 2, 6 / c1, c1 * 2, 2 * c1,
                     c1 == c2, c1 < c2, c1.value], "snap1": reg.snapshot()}
    c1.inc(10)
    hist.observe(32.0)
    out["delta"] = reg.delta(out["snap1"])
    out["summary"] = hist.summary()
    fired = []

    class Comp:
        def hook(self):
            fired.append(reg.snapshot())

    comp = Comp()
    reg.on_reset(comp.hook)
    reg.reset()
    out["after_reset"] = reg.snapshot()
    del comp
    c2.inc(2)
    reg.reset()
    out["fired"] = fired
    out["final"] = reg.snapshot()
    out["n_metrics"] = len(reg.metrics())
    return out


@pytest.mark.parametrize("window", [1, 4, 8192])
def test_registry_matches_reference(window):
    """The same operations on both packages' registries: equal snapshots
    key for key and value for value, the same delta, the same reset (gauges
    kept) and the same hook calls."""
    assert _registry_script(T.registry, window) == _registry_script(J.registry, window)


# ------------------------------------------- one reset, no drift
def test_registry_reset_zeroes_every_published_counter():
    """After warm-up, ONE registry-level reset() zeroes every published
    counter together, and re-baselines the engine's derived deltas (its
    on_reset hook)."""
    tr = _trainer(materialized_rows=64)
    tr.train(3, log_every=0)
    engine = _engine(dim=12, cfg=_cfg(max_batch=8))
    try:
        for f in engine.submit_many(_workload(8, seed=3)):
            f.result(timeout=60)
        assert tr.executor.cache_stats()["schedule"]["misses"] > 0
        assert engine.stats()["submitted"] == 8 and engine.stats()["retraces"] > 0
        get_registry().reset()
        for m in get_registry().metrics():
            if m.kind == "counter":
                assert m.read() == 0, f"{metric_key(m)} survived reset()"
            elif m.kind == "histogram":
                assert m.count == 0, f"{metric_key(m)} survived reset()"
        cs = tr.executor.cache_stats()
        assert all(cs[k]["hits"] == 0 and cs[k]["misses"] == 0 for k in cs)
        st = engine.stats()
        assert st["submitted"] == 0 and st["completed"] == 0
        assert st["batches"] == 0 and st["coalesced"] == 0
        assert all(v == 0 for v in st["flushes"].values())
        assert st["retraces"] == 0  # re-baselined by the on_reset hook
        assert st["sharing"]["nodes_before"] == 0
        sh = tr.executor.sharing_stats()
        assert sh["nodes_before"] == 0 and sh["plan_cache"]["hits"] == 0
        assert sh["materialized"]["hits"] == 0
    finally:
        engine.close()


def _cfg(**kw):
    from repro_torch.serving import ServingConfig

    return ServingConfig(**kw)


def test_engine_latency_window_and_window_n():
    engine = _engine(dim=10, cfg=_cfg(max_batch=4, latency_window=4))
    try:
        for f in engine.submit_many(_workload(6, seed=5)):
            f.result(timeout=60)
        lm = engine.stats()["latency_ms"]
        assert lm["window"] == 4
        assert lm["window_n"] == 4  # 6 observed, window keeps the last 4
        assert lm["n"] == 4  # percentiles computed over the window
    finally:
        engine.close()
    with pytest.raises(ValueError):
        _engine(dim=10, cfg=_cfg(latency_window=0))


# -------------------------------------------------------------------- tracer
def test_disabled_tracer_is_free_and_silent():
    TRACER.disable()
    s1 = TRACER.span("a", n=1)
    s2 = TRACER.span("b")
    assert s1 is s2  # shared null context: the one-attribute-read fast path
    with s1:
        pass
    TRACER.instant("x")
    TRACER.counter("q", depth=3)
    TRACER.async_begin("r", 1)
    TRACER.async_end("r", 1)
    assert TRACER._events == []


def test_spans_nest_within_and_across_threads():
    TRACER.enable(profiler_annotations=False)
    TRACER.set_lane("main dispatch")
    with TRACER.span("outer"):
        with TRACER.span("inner"):
            time.sleep(0.002)

    def worker():
        TRACER.set_lane("pipeline scheduler")
        with TRACER.span("schedule"):
            with TRACER.span("transfer"):
                time.sleep(0.002)

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    obj = TRACER.to_json()
    s = validate_trace(obj)
    assert {"main dispatch", "pipeline scheduler"} <= set(s["lanes"])
    ev = {e["name"]: e for e in obj["traceEvents"] if e["ph"] == "X"}
    for child, parent in (("inner", "outer"), ("transfer", "schedule")):
        c, p = ev[child], ev[parent]
        assert c["tid"] == p["tid"]
        assert p["ts"] <= c["ts"]
        assert c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1e-3
    assert ev["outer"]["tid"] != ev["schedule"]["tid"]


def test_set_lane_survives_enable():
    """Long-lived threads (batcher, scheduler) name their lane once at
    thread start — possibly before enable(); the name must still appear."""
    TRACER.disable()
    done, go = threading.Event(), threading.Event()

    def worker():
        TRACER.set_lane("early bird")  # registered while disabled
        done.set()
        go.wait(5)
        with TRACER.span("work"):
            pass

    t = threading.Thread(target=worker)
    t.start()
    done.wait(5)
    TRACER.enable(profiler_annotations=False)
    go.set()
    t.join(timeout=30)
    s = validate_trace(TRACER.to_json())
    assert "early bird" in s["lanes"] and "work" in s["names"]


def test_max_events_truncation():
    TRACER.enable(profiler_annotations=False, max_events=3)
    try:
        for i in range(10):
            TRACER.instant(f"e{i}")
        obj = TRACER.to_json()
    finally:
        TRACER.enable(profiler_annotations=False, max_events=2_000_000)  # restore
    data = [e for e in obj["traceEvents"] if e["ph"] != "M"]
    assert len(data) == 3
    assert obj["otherData"]["truncated"] is True
    validate_trace(obj)


def test_span_bridges_to_torch_profiler():
    """With annotations on, a span is a ``record_function`` range: its name
    is a user annotation in a ``torch.profiler`` trace, over the ops run
    under it."""
    from torch.profiler import ProfilerActivity, profile

    TRACER.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TRACER.span("dispatch"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    TRACER.disable()
    names = {e.name for e in prof.events()}
    assert "dispatch" in names and "aten::mm" in names
    assert [e["name"] for e in TRACER.to_json()["traceEvents"] if e["ph"] == "X"] == [
        "dispatch"]


MALFORMED = {
    "no traceEvents": {"events": []},
    "missing dur": {"traceEvents": [{"name": "a", "ph": "X", "ts": 0.0, "pid": 1,
                                     "tid": 1}]},
    "bad dur": {"traceEvents": [{"name": "a", "ph": "X", "ts": 0.0, "dur": -1.0,
                                 "pid": 1, "tid": 1}]},
    "unsupported phase": {"traceEvents": [{"name": "a", "ph": "Z"}]},
    "not an object": {"traceEvents": [["X"]]},
    "non-numeric ts": {"traceEvents": [{"name": "a", "ph": "i", "ts": "0", "pid": 1,
                                        "tid": 1}]},
    "nameless lane": {"traceEvents": [{"name": "thread_name", "ph": "M", "pid": 1,
                                       "tid": 1, "args": {"name": ""}}]},
    "end without begin": {"traceEvents": [{"name": "r", "ph": "e", "ts": 0.0, "id": 1,
                                           "pid": 1, "tid": 1, "cat": "request"}]},
    "unbalanced": {"traceEvents": [{"name": "r", "ph": "b", "ts": 0.0, "id": 1,
                                    "pid": 1, "tid": 1, "cat": "request"}]},
}


def test_validate_trace_rejects_malformed():
    for match, key in (("traceEvents", "no traceEvents"), ("missing key", "missing dur"),
                       ("bad dur", "bad dur"), ("unsupported phase", "unsupported phase"),
                       ("without begin", "end without begin"), ("unbalanced", "unbalanced")):
        with pytest.raises(ValueError, match=match):
            validate_trace(MALFORMED[key])


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_validate_trace_rejects_what_the_reference_rejects(case):
    with pytest.raises(ValueError) as want:
        J.validate_trace(MALFORMED[case])
    with pytest.raises(ValueError) as got:
        T.validate_trace(MALFORMED[case])
    assert str(got.value) == str(want.value)


def _tracer_script(tr, **enable):
    """One sequence of tracer calls from two threads on a fresh tracer."""
    tr.enable(**enable)
    tr.set_lane("main dispatch")
    with tr.span("outer", n=3):
        with tr.span("inner"):
            pass
    tr.instant("flush", kind="size")
    tr.counter("queue_depth", depth=2)
    rid = tr.next_id()
    tr.async_begin("request", rid, pattern="1p", top_k=5)
    with tr.span("plain"):
        pass

    def worker():
        tr.set_lane("pipeline scheduler")
        with tr.span("schedule", n=1):
            tr.counter("prepared_q_depth", depth=1)
        tr.async_end("request", rid, latency_ms=1.5)

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    return tr.to_json()


def _strip(obj):
    return {**obj, "traceEvents": [{k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
                                   for e in obj["traceEvents"]]}


@pytest.mark.parametrize("max_events", [2_000_000, 5])
def test_tracer_events_match_reference(max_events):
    """The same tracer calls give the same events on both packages, apart
    from times and thread ids; truncation flags the same file."""
    want = _tracer_script(J.SpanTracer(), jax_annotations=False, max_events=max_events)
    got = _tracer_script(T.SpanTracer(), profiler_annotations=False,
                         max_events=max_events)
    assert _strip(got) == _strip(want)
    assert ("otherData" in got) == (max_events == 5)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_validate_trace_accepts_the_other_packages_output(writer):
    obj = (_tracer_script(T.SpanTracer(), profiler_annotations=False) if writer == "port"
           else _tracer_script(J.SpanTracer(), jax_annotations=False))
    obj = json.loads(json.dumps(obj))
    assert T.validate_trace(obj) == J.validate_trace(obj)
    assert T.validate_trace(obj)["lanes"] == ["main dispatch", "pipeline scheduler"]


# ------------------------------------------------ trace ids through serving
def test_request_spans_thread_submit_to_complete():
    engine = _engine(dim=14, cfg=_cfg(max_batch=4))
    try:
        TRACER.enable(profiler_annotations=False)
        for f in engine.submit_many(_workload(6, seed=9)):
            f.result(timeout=60)
        obj = TRACER.to_json()
        TRACER.disable()
        s = validate_trace(obj)  # includes b/e balance per (cat, id, name)
        begins = [e for e in obj["traceEvents"] if e["ph"] == "b" and e["name"] == "request"]
        assert len(begins) == 6
        assert len({e["id"] for e in begins}) == 6  # one async span each
        assert {"batch", "encode", "score", "select", "serving_queue_depth"} <= set(s["names"])
        assert "serving batcher" in s["lanes"]
        ends = [e for e in obj["traceEvents"] if e["ph"] == "e"]
        assert all(e["args"]["latency_ms"] > 0 for e in ends)
    finally:
        engine.close()


def test_coalesced_requests_keep_distinct_request_spans():
    """Duplicate in-flight requests share ONE computed row (one batch/encode
    span) but each keeps its own request span."""
    engine = _engine(dim=14, cfg=_cfg(max_batch=8, max_wait_ms=100.0))
    try:
        q = _workload(1, seed=9)[0]
        TRACER.enable(profiler_annotations=False)
        for f in engine.submit_many([q] * 8):
            f.result(timeout=60)
        obj = TRACER.to_json()
        TRACER.disable()
        validate_trace(obj)
        ids = {e["id"] for e in obj["traceEvents"] if e["ph"] == "b" and e["name"] == "request"}
        assert len(ids) == 8
        batches = [e for e in obj["traceEvents"] if e["ph"] == "X" and e["name"] == "batch"]
        assert len(batches) < 8
        assert any(len(b["args"]["trace_ids"]) > 1 for b in batches)
        covered = [i for b in batches for i in b["args"]["trace_ids"]]
        assert sorted(covered) == sorted(ids)
        assert engine.stats()["coalesced"] >= 1
    finally:
        engine.close()


def _ends(obj):
    return [e for e in obj["traceEvents"] if e["ph"] == "e" and e["name"] == "request"]


@pytest.mark.parametrize("outcome", ["shed", "rejected", "failed", "closed"])
def test_request_spans_close_on_every_outcome(outcome):
    """A request's span ends however the request ends — shed for staleness,
    rejected at a full queue, failed in its batch, failed at close — so the
    trace validates (every b has its e) with the outcome on the end."""
    from repro_torch.core import QueryInstance
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.serving import StaleVersionError

    qs = _workload(3, seed=21)
    TRACER.enable(profiler_annotations=False)
    if outcome == "shed":
        kg = generate_synthetic_kg(200, 10, 2400, seed=0)
        engine = _engine(kg=kg, started=False, cfg=_cfg(max_staleness_versions=0))
        fut = engine.submit(qs[0], pin_version=kg.graph_version)
        cand = np.array([[0, 0, 1], [2, 1, 3], [4, 2, 5]])
        kg.insert_triples(cand[~kg.contains(cand)])
        engine.start()
        with pytest.raises(StaleVersionError):
            fut.result(timeout=60)
        engine.close()
    elif outcome == "rejected":
        engine = _engine(started=False, cfg=_cfg(queue_depth=1))
        engine.submit(qs[0])
        with pytest.raises(queue.Full):
            engine.submit(qs[1], timeout=0)
        with pytest.raises(queue.Full):
            engine.submit_many(qs[1:], timeout=0)
        engine.close(drain=False)
    elif outcome == "failed":
        engine = _engine(cfg=_cfg(max_batch=4, max_wait_ms=50.0))
        bad = QueryInstance("no-such-pattern", np.array([1]), np.array([0]))
        futures = engine.submit_many(qs + [bad])
        with pytest.raises(KeyError):
            futures[-1].result(timeout=60)
        engine.close()
    else:
        engine = _engine(started=False)
        futures = engine.submit_many(qs)
        engine.close(drain=False)
        with pytest.raises(RuntimeError, match="closed"):
            futures[0].result(timeout=60)
    obj = TRACER.to_json()
    TRACER.disable()
    validate_trace(obj)
    flags = [k for e in _ends(obj) for k in e.get("args", {}) if k != "latency_ms"]
    want = {"shed": ["shed"], "rejected": ["rejected"] * 3 + ["failed"],
            "failed": ["failed"], "closed": ["failed"] * 3}[outcome]
    assert sorted(flags) == sorted(want)


def test_engine_semantic_spans_and_store_io():
    """Out of core, the batcher stages each micro-batch's anchors under a
    ``sem_prefetch`` span, and the cache's store read is a ``store_io`` span
    with the rows it read."""
    from repro_torch.core import PooledExecutor
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.semantic import SemanticCache
    from repro_torch.serving import ServingEngine

    kg = graphs()[1]
    table = np.random.default_rng(3).normal(size=(kg.n_entities, 16)).astype(np.float32)
    cache = SemanticCache(table, budget_rows=64, device="cpu")
    model = make_model("gqe", ModelConfig(dim=8, semantic_dim=16, semantic_proj_dim=8),
                       device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0), kg.n_entities,
                               kg.n_relations, semantic_cache=cache)
    engine = ServingEngine(model, params, device="cpu", cfg=_cfg(max_batch=4),
                           executor=PooledExecutor(model, b_max=64, device="cpu"),
                           sem_cache=cache, sem_rows_fn=lambda ids: table[ids])
    TRACER.enable(profiler_annotations=False)
    try:
        for f in engine.submit_many(_workload(6, seed=4)):
            f.result(timeout=60)
    finally:
        engine.close()
    obj = TRACER.to_json()
    TRACER.disable()
    s = validate_trace(obj)
    assert {"sem_prefetch", "store_io", "encode", "score", "select"} <= set(s["names"])
    io_rows = sum(e["args"]["rows"] for e in obj["traceEvents"] if e["name"] == "store_io")
    assert io_rows == cache.stats()["rows_staged"] > 0


def test_router_route_spans():
    """The router's ``route`` span carries the pattern and tenant of every
    single-request admission, a shed included; each replica names its
    batcher lane."""
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.serving import ReplicaPool, Router, RouterConfig, ShedError, TenantSpec

    kg = graphs()[1]
    model = make_model("gqe", ModelConfig(dim=8), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0), kg.n_entities,
                               kg.n_relations)
    pool = ReplicaPool(model, params, n_replicas=2, device="cpu", b_max=64,
                       cfg=_cfg(max_batch=4, max_wait_ms=20.0))
    router = Router(pool, tenants=[TenantSpec("gold", "high"), TenantSpec("bronze", "low")],
                    cfg=RouterConfig(low_priority_depth=0))
    qs = _workload(6, seed=31)
    TRACER.enable(profiler_annotations=False)
    try:
        futures = [router.submit(q, tenant="gold") for q in qs]
        with pytest.raises(ShedError):
            router.submit(qs[0], tenant="bronze")   # depth 0: always shed
        for f in futures:
            f.result(timeout=60)
    finally:
        router.close()
    obj = TRACER.to_json()
    TRACER.disable()
    s = validate_trace(obj)
    routes = [e for e in obj["traceEvents"] if e["ph"] == "X" and e["name"] == "route"]
    assert [(e["args"]["pattern"], e["args"]["tenant"]) for e in routes] == (
        [(q.pattern, "gold") for q in qs] + [(qs[0].pattern, "bronze")])
    assert sum(e["ph"] == "b" for e in obj["traceEvents"]) == len(qs)
    assert {"replica 0 batcher", "replica 1 batcher"} <= set(s["lanes"])


# ------------------------------------------------------- sink + breakdowns
def test_metrics_sink_disabled_and_roundtrip(tmp_path):
    off = MetricsSink(None)
    assert not off.enabled
    off.write({"kind": "step"})  # no-op
    assert off.records == 0
    p = tmp_path / "m.jsonl"
    with MetricsSink(str(p)) as sink:
        assert sink.enabled
        sink.write({"kind": "step", "loss": 1.5})
        sink.write({"kind": "snapshot", "metrics": {"a": 1}})
    recs = read_jsonl(str(p))
    assert [r["kind"] for r in recs] == ["step", "snapshot"]
    assert recs[0]["loss"] == 1.5


def test_sync_trainer_writes_step_records(tmp_path):
    p = tmp_path / "sync.jsonl"
    tr = _trainer(metrics_path=str(p))
    tr.train(3, log_every=0)
    recs = read_jsonl(str(p))
    assert len(recs) == 3
    for r in recs:
        assert r["kind"] == "step" and r["mode"] == "sync"
        assert "loss" in r and "schedule_s" in r and "retire_s" in r
    # history records are untouched: the JSONL is a separate surface
    assert set(tr.history[0]) == {"step", "loss", "queries_per_sec"}


def test_pipelined_trainer_writes_bubble_fraction(tmp_path):
    from repro_torch.sampling import OnlineSampler

    p = tmp_path / "pipe.jsonl"
    batches = [OnlineSampler(graphs()[1], seed=17).sample_batch(8)]
    tr = _trainer(pipeline=True, metrics_path=str(p))
    tr.train(4, log_every=0, batches=batches)
    recs = read_jsonl(str(p))
    assert len(recs) == 4
    for r in recs:
        assert r["mode"] == "pipelined"
        assert 0.0 <= r["bubble_frac"] <= 1.0
        assert r["wall_s"] > 0
        assert "wait_s" in r and "schedule_s" in r and "transfer_s" in r


def test_phase_counters_register_in_snapshot():
    from repro_torch.sampling import OnlineSampler

    tr = _trainer()
    tr.train(2, log_every=0, batches=[OnlineSampler(graphs()[1], seed=0).sample_batch(8)])
    snap = get_registry().snapshot()
    assert snap["trainer_steps"] >= 2
    assert snap["trainer_phase_seconds{phase=dispatch}"] > 0
    assert snap["trainer_phase_seconds{phase=retire}"] > 0


# ------------------------------------- trainers against the JAX package's
_PATTERNS = ("1p", "2p", "2i", "2u")


def _pair_trainer(package, family, mode, metrics_path=None, table=None):
    """The JAX package's trainer (``package="reference"``) or the port's on
    the shared graph, one config for both; ``table`` puts it behind a
    184-row hot set of H_sem."""
    if package == "reference":
        from repro.models import ModelConfig, make_model
        from repro.semantic import SemanticCache
        from repro.training import AdamConfig, NGDBTrainer, TrainConfig
        kg, dev = graphs()[0], {}
    else:
        from repro_torch.models import ModelConfig, make_model
        from repro_torch.semantic import SemanticCache
        from repro_torch.training import AdamConfig, NGDBTrainer, TrainConfig
        kg, dev = graphs()[1], {"device": "cpu"}
    mkw = dict(dim=8) if table is None else dict(dim=8, semantic_dim=table.shape[1],
                                                 semantic_proj_dim=8)
    sem = {} if table is None else {
        "semantic_cache": SemanticCache(table, budget_rows=184, **dev)}
    cfg = TrainConfig(batch_size=8, n_negatives=4, b_max=32, seed=0, prefetch=2,
                      pipeline=mode == "pipelined", patterns=_PATTERNS,
                      adam=AdamConfig(lr=1e-3), metrics_path=metrics_path)
    return NGDBTrainer(make_model(family, ModelConfig(**mkw), **dev), kg, cfg, **sem)


def _batches(package, seed, n=2):
    if package == "reference":
        from repro.sampling import OnlineSampler
    else:
        from repro_torch.sampling import OnlineSampler
    s = [OnlineSampler(graphs()[package != "reference"], patterns=_PATTERNS, seed=seed + i)
         for i in range(n)]
    return [x.sample_batch(8) for x in s]


def _lane_names(obj):
    """{lane: span and counter names on it}, read from the events."""
    lanes = {e["tid"]: e["args"]["name"] for e in obj["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    out = {}
    for e in obj["traceEvents"]:
        if e["ph"] in ("X", "C"):
            out.setdefault(lanes[e["tid"]], set()).add(
                "dispatch" if e["name"] == "compile" else e["name"])
    return out


@pytest.mark.parametrize("mode", ["sync", "pipelined"])
@pytest.mark.parametrize("family", ["gqe", "betae", "gqe+hot set"])
def test_trainer_records_and_spans_match_reference(family, mode, tmp_path):
    """The same batches through the JAX package's trainer and the port's,
    both traced: step records with the reference's keys (the port writes
    ``dispatch_s`` where the reference wrote ``compile_s`` for a cold
    signature), each lane with the reference's span names (``compile`` read
    as ``dispatch``), and the port's losses bitwise those of an untraced
    run."""
    table = None
    if family == "gqe+hot set":
        t = np.random.default_rng(21).normal(size=(200, 16))
        table = (t / np.linalg.norm(t, axis=1, keepdims=True)).astype(np.float32)
    name = family.split("+")[0]
    jb, tb = _batches("reference", 50), _batches("port", 50)
    jt = _pair_trainer("reference", name, mode, str(tmp_path / "j.jsonl"), table)
    tt = _pair_trainer("port", name, mode, str(tmp_path / "t.jsonl"), table)
    J.TRACER.enable(jax_annotations=False)
    jt.train(3, log_every=0, batches=jb)
    want = _lane_names(J.TRACER.to_json())
    J.TRACER.disable()
    TRACER.enable()
    tt.train(3, log_every=0, batches=tb)
    obj = TRACER.to_json()
    TRACER.disable()
    validate_trace(obj)
    assert _lane_names(obj) == want
    jrec, trec = read_jsonl(str(tmp_path / "j.jsonl")), read_jsonl(str(tmp_path / "t.jsonl"))
    assert [("dispatch_s" if k == "compile_s" else k) for r in jrec for k in r] == [
        k for r in trec for k in r]
    assert [(r["kind"], r["mode"], r["step"]) for r in trec] == [
        (r["kind"], r["mode"], r["step"]) for r in jrec]
    untraced = _pair_trainer("port", name, mode, table=table)
    untraced.train(3, log_every=0, batches=tb)
    assert [r["loss"] for r in untraced.history] == [r["loss"] for r in tt.history]


# ------------------------------------------------------------------- report
def test_report_summarizers():
    TRACER.enable(profiler_annotations=False)
    TRACER.set_lane("main dispatch")
    with TRACER.span("dispatch"):
        time.sleep(0.001)
    out = summarize_trace(TRACER.to_json())
    TRACER.disable()
    assert "main dispatch" in out and "dispatch" in out
    steps = [{"kind": "step", "mode": "pipelined", "wall_s": 0.1,
              "wait_s": 0.01, "dispatch_s": 0.08, "bubble_frac": 0.1}] * 3
    out = summarize_metrics(steps)
    assert "3 step records" in out and "pipeline bubble" in out
    assert summarize_metrics([]).startswith("metrics: no step records")
    out = cache_tables({"cache_hits{cache=encode}": 3, "cache_misses{cache=encode}": 1,
                        "plan_cache_hits": 9, "plan_cache_misses": 1,
                        "unrelated_gauge": 5})
    assert "cache{cache=encode}" in out and "75.0%" in out
    assert "plan_cache" in out and "90.0%" in out


def test_report_cli_end_to_end(tmp_path):
    """Train with the trace and metrics on, then summarize both files."""
    from repro_torch.obs.report import main as report_main

    p, tp = tmp_path / "m.jsonl", tmp_path / "t.json"
    TRACER.enable(profiler_annotations=False)
    tr = _trainer(metrics_path=str(p))
    tr.train(2, log_every=0)
    tr.metrics_sink.write({"kind": "snapshot", "metrics": get_registry().snapshot()})
    tr.metrics_sink.close()
    TRACER.write(str(tp))
    TRACER.disable()
    validate_trace(json.load(open(tp)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report_main(["--trace", str(tp), "--metrics", str(p)])
    assert "lane [main dispatch]" in out.getvalue() and "caches:" in out.getvalue()


@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    """A trace and a metrics file from a pipelined run of each package's
    trainer (GQE, dim 8, two batches), with a registry snapshot last."""
    d = tmp_path_factory.mktemp("obs_runs")
    out = {}
    for writer, obs in (("reference", J), ("port", T)):
        trace, metrics = str(d / f"{writer}.trace.json"), str(d / f"{writer}.jsonl")
        tr = _pair_trainer(writer, "gqe", "pipelined", metrics)
        obs.TRACER.enable(**({"jax_annotations": False} if writer == "reference"
                             else {"profiler_annotations": False}))
        tr.train(4, log_every=0, batches=_batches(writer, 60))
        tr.metrics_sink.write({"kind": "snapshot", "metrics": obs.get_registry().snapshot()})
        tr.metrics_sink.close()
        obs.TRACER.write(trace)
        obs.TRACER.disable()
        out[writer] = (trace, metrics)
    return out


@pytest.mark.parametrize("sections", ["trace", "metrics", "both"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_report_output_equals_reference(writer, sections, run_files):
    """``python -m repro_torch.obs.report`` prints exactly what
    ``python -m repro.obs.report`` prints for the same files, written by
    either package's trainer."""
    from repro.obs.report import main as j_main
    from repro_torch.obs.report import main as t_main

    trace, metrics = run_files[writer]
    argv = {"trace": ["--trace", trace], "metrics": ["--metrics", metrics],
            "both": ["--trace", trace, "--metrics", metrics, "--top", "3"]}[sections]
    outs = []
    for fn in (j_main, t_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(argv)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and outs[0]
