"""The port's live-write tier against the JAX package: graph writes,
``SemanticStore.append_rows``, entity growth, version-pinned serving, the
background fine-tune (``incremental_finetune``, ``LiveNGDB``)."""
import gc
import os

import jax
import numpy as np
import pytest
import torch

from torch_parity import FP32

torch.set_num_threads(1)


# ------------------------------------------------------------ graph writes
def _both_graphs(seed=3):
    from repro.data import generate_synthetic_kg as j_gen
    from repro_torch.data import generate_synthetic_kg as t_gen

    return j_gen(60, 4, 300, seed=seed), t_gen(60, 4, 300, seed=seed)


def _assert_same_graph(j, t):
    assert (t.version, t.graph_version, t.n_entities) == (j.version, j.graph_version,
                                                          j.n_entities)
    assert t.retained_versions() == j.retained_versions()
    np.testing.assert_array_equal(t.triples, j.triples)
    np.testing.assert_array_equal(t._adj.hr, j._adj.hr)
    np.testing.assert_array_equal(t._adj.tails, j._adj.tails)
    np.testing.assert_array_equal(t.out_degree, j.out_degree)
    np.testing.assert_array_equal(t.degree, j.degree)
    np.testing.assert_array_equal(t.edges_with_outgoing, j.edges_with_outgoing)
    for a, b in zip(t.incoming_by_tail, j.incoming_by_tail):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kg_writes_match_reference(seed):
    """One seeded sequence of writes — fresh, duplicate, partly duplicate,
    out of range, entity growth — on both packages' graphs: the returned
    fresh rows, the CSR arrays, the versions, the snapshots and the cached
    views are equal after every write."""
    j, t = _both_graphs()
    rng = np.random.default_rng(seed)
    fired = {"j": [], "t": []}

    def j_listener(reason):
        fired["j"].append(reason)

    def t_listener(reason):
        fired["t"].append(reason)

    j.add_invalidation_listener(j_listener)
    t.add_invalidation_listener(t_listener)
    for step in range(12):
        op = int(rng.integers(4))
        if op == 0:     # fresh and repeated rows, duplicates within the burst
            rows = np.stack([rng.integers(0, j.n_entities, 6),
                             rng.integers(0, j.n_relations, 6),
                             rng.integers(0, j.n_entities, 6)], axis=1)
            rows = np.concatenate([rows, rows[:2], j.triples[:2]])
            np.testing.assert_array_equal(t.insert_triples(rows), j.insert_triples(rows))
        elif op == 1:   # all duplicates: a no-op
            v = t.version
            assert len(t.insert_triples(t.triples[:5])) == 0
            assert len(j.insert_triples(j.triples[:5])) == 0
            assert t.version == v
        elif op == 2:
            n = int(rng.integers(0, 3))
            assert t.add_entities(n) == j.add_entities(n)
        else:           # a write that raises changes nothing
            bad = [[j.n_entities, 0, 0]] if step % 2 else [[0, j.n_relations, 0]]
            v = t.version
            with pytest.raises(ValueError):
                t.add_triples(bad)
            with pytest.raises(ValueError):
                j.add_triples(bad)
            assert t.version == v
        _assert_same_graph(j, t)
    assert fired["t"] == fired["j"]
    for v in t.retained_versions():
        a, b = t.snapshot_at(v), j.snapshot_at(v)
        assert (a.graph_version, a.n_entities, len(a)) == (b.graph_version, b.n_entities, len(b))
        np.testing.assert_array_equal(a.triples, b.triples)
        h, r = int(b.triples[0, 0]), int(b.triples[0, 1])
        np.testing.assert_array_equal(a.neighbors(h, r), b.neighbors(h, r))


def test_kg_snapshots_retention_and_listeners():
    from repro_torch.data import KnowledgeGraph, SnapshotUnavailable

    kg = KnowledgeGraph(10, 2, np.array([[0, 0, 1]]), snapshot_retention=2)
    snap0 = kg.snapshot()
    kg.add_triples([[1, 0, 2]])
    kg.add_triples([[2, 1, 3]])
    assert kg.retained_versions() == (1, 2)
    with pytest.raises(SnapshotUnavailable):
        kg.snapshot_at(0)
    assert len(snap0) == 1 and len(kg.snapshot_at(1)) == 2 and len(kg) == 3
    assert snap0.contains([[1, 0, 2]]).tolist() == [False]

    class Sink:
        def __init__(self):
            self.reasons = []

        def hear(self, reason):
            self.reasons.append(reason)

    sink = Sink()
    kg.add_invalidation_listener(sink.hear)
    kg.add_entities(1)
    assert sink.reasons == ["entity_add"] and kg.live_listener_count() == 1
    del sink
    gc.collect()
    assert kg.live_listener_count() == 0
    with pytest.raises(ValueError):
        KnowledgeGraph(4, 2, np.array([[0, 0, 1]]), snapshot_retention=0)


# ----------------------------------------------------------- store growth
def _stores(tmp_path, rows, quant, shard_rows=4):
    from repro.semantic import SemanticStore as JStore
    from repro.semantic import SemanticStoreWriter as JWriter
    from repro_torch.semantic import SemanticStore as TStore
    from repro_torch.semantic import SemanticStoreWriter as TWriter

    out = []
    for tag, W, S in (("j", JWriter, JStore), ("t", TWriter, TStore)):
        d = str(tmp_path / f"{tag}-{quant}")
        w = W(d, dim=rows.shape[1], quant=quant, shard_rows=shard_rows)
        w.append(rows)
        w.finalize()
        out.append(S(d))
    return out


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_append_rows_bytes_match_reference(tmp_path, quant):
    """Two appends (a ragged top-up, then new shards) on a store of each
    package: every stored byte, meta.json included, and every ``read_rows``
    are equal, and the old rows read bitwise as before."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=(10, 8)).astype(np.float32)   # 2 full + 1 ragged
    js, ts = _stores(tmp_path, base, quant)
    before = ts.read_rows(np.arange(10))
    for extra in (rng.normal(size=(9, 8)).astype(np.float32),
                  rng.normal(size=(3, 8)).astype(np.float32)):
        assert ts.append_rows(extra) == js.append_rows(extra)
        assert _files(ts.directory) == _files(js.directory)
        np.testing.assert_array_equal(ts.read_rows(np.arange(ts.n_rows)),
                                      js.read_rows(np.arange(js.n_rows)))
    np.testing.assert_array_equal(ts.read_rows(np.arange(10)), before)
    from repro_torch.semantic import SemanticStore

    reopened = SemanticStore(ts.directory)
    assert reopened.n_rows == 22
    np.testing.assert_array_equal(reopened.read_rows(np.arange(10)), before)
    assert ts.append_rows(np.zeros((0, 8), np.float32)) == range(22, 22)


def test_append_rows_crash_safe(tmp_path, monkeypatch):
    """A crash between the shard writes and the meta publish leaves the OLD
    store openable with its old rows bitwise intact; the append can be
    retried."""
    import repro_torch.semantic.store as store_mod
    from repro_torch.semantic import SemanticStore

    rng = np.random.default_rng(6)
    base = rng.normal(size=(10, 8)).astype(np.float32)
    _, store = _stores(tmp_path, base, "fp32")
    before = store.read_rows(np.arange(10))
    real = store_mod._write_atomic

    def boom(path, payload):
        if path.endswith("meta.json"):
            raise OSError("simulated crash before meta publish")
        real(path, payload)

    monkeypatch.setattr(store_mod, "_write_atomic", boom)
    with pytest.raises(OSError, match="simulated crash"):
        store.append_rows(rng.normal(size=(7, 8)).astype(np.float32))
    monkeypatch.setattr(store_mod, "_write_atomic", real)
    reopened = SemanticStore(store.directory)
    assert reopened.n_rows == 10
    np.testing.assert_array_equal(reopened.read_rows(np.arange(10)), before)
    assert store.n_rows == 10
    store.append_rows(rng.normal(size=(7, 8)).astype(np.float32))
    assert SemanticStore(store.directory).n_rows == 17


# ----------------------------------------------------------- params growth
def _model(name="gqe", **cfg):
    from repro_torch.models import ModelConfig, make_model

    return make_model(name, ModelConfig(dim=8, gamma=6.0, **cfg), device="cpu")


def test_grow_entity_rows_claims_padding_first():
    from repro_torch.serving import grow_entity_rows

    model = _model(entity_pad=8)
    params = model.init_params(torch.Generator().manual_seed(0), 10, 4)
    assert params["entity"].shape[0] == 16
    ent = params["entity"]
    grown = grow_entity_rows(model, params, 3)
    assert model.n_entities == 13
    assert grown["entity"] is ent           # pad rows claimed, no realloc
    grown2 = grow_entity_rows(model, grown, 5, seed=2, version=7)
    assert model.n_entities == 18 and grown2["entity"].shape[0] == 24
    np.testing.assert_array_equal(grown2["entity"][:16].numpy(), ent.numpy())
    new = grown2["entity"][16:]
    # Reproducible from (seed, version), distinct across versions.
    model.n_entities = 16
    again = grow_entity_rows(model, grown, 5, seed=2, version=7)["entity"][16:]
    model.n_entities = 16
    other = grow_entity_rows(model, grown, 5, seed=2, version=8)["entity"][16:]
    assert torch.equal(again, new) and not torch.equal(other, new)
    assert 0.1 < float(new.std()) * np.sqrt(8) < 3.0   # N(0, 1/sqrt(d))


def test_grow_entity_rows_sem_table():
    from repro_torch.serving import grow_entity_rows

    model = _model(semantic_dim=4, entity_pad=4)
    table = np.arange(10 * 4, dtype=np.float32).reshape(10, 4)
    params = model.init_params(torch.Generator().manual_seed(0), 10, 4,
                               semantic_table=table)
    with pytest.raises(ValueError, match="sem_rows"):
        grow_entity_rows(model, params, 2)
    new_rows = np.full((3, 4), 7.0, np.float32)
    grown = grow_entity_rows(model, params, 3, sem_rows=new_rows)
    st = grown["sem_table"].numpy()
    assert st.shape == (16, 4)
    np.testing.assert_array_equal(st[:10], table)
    np.testing.assert_array_equal(st[10:13], new_rows)
    assert not st[13:].any()


def test_grow_entity_rows_rejects_hot_set_layout():
    from repro_torch.serving import grow_entity_rows

    model = _model()
    model.n_entities = 10
    params = {"entity": torch.zeros((10, 8)),
              "sem_slot": torch.zeros(10, dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="hot set"):
        grow_entity_rows(model, params, 2)


# ----------------------------------------------------- incremental fine-tune
def _carried(name, dim=16, seed=0):
    """A JAX-package model and params on the tiny graph, and the port's
    model carrying the same weights (fresh each call: fine-tunes grow and
    update them)."""
    from repro.data import generate_synthetic_kg as j_gen
    from repro.models import ModelConfig as JCfg, make_model as j_make
    from repro_torch.models import ModelConfig as TCfg, make_model as t_make
    from repro_torch.models import params_from_numpy

    jkg = j_gen(200, 10, 2400, seed=0)
    jm = j_make(name, JCfg(dim=dim, gamma=6.0))
    jp = jm.init_params(jax.random.PRNGKey(seed), jkg.n_entities, jkg.n_relations)
    tm = t_make(name, TCfg(dim=dim, gamma=6.0), device="cpu")
    tp = params_from_numpy(tm, {k: np.asarray(v) for k, v in jp.items()})
    return jkg, jm, jp, tm, tp


def _record_loss_inputs(monkeypatch, module, store):
    real = module.negative_sampling_loss

    def rec(model, params, q, pos, neg):
        store.append((np.asarray(pos), np.asarray(neg)))
        return real(model, params, q, pos, neg)

    monkeypatch.setattr(module, "negative_sampling_loss", rec)


@pytest.mark.parametrize("name,steps", [("gqe", 4), ("betae", 3)])
def test_incremental_finetune_matches_reference(name, steps, monkeypatch):
    """Negatives exact (recorded at the loss of each package — the
    reference's step runs eagerly for the recording), losses and every
    parameter at the family's tolerance: GQE rtol 1e-4, BetaE rtol 1e-3."""
    import repro.training.loop as jloop
    import repro_torch.training.loop as tloop

    jkg, jm, jp, tm, tp = _carried(name)
    burst = jkg.triples[np.random.default_rng(3).choice(len(jkg), 10, replace=False)]
    rec_j, rec_t = [], []
    _record_loss_inputs(monkeypatch, jloop, rec_j)
    _record_loss_inputs(monkeypatch, tloop, rec_t)
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    want, jl = jloop.incremental_finetune(jm, jp, burst, steps=steps, lr=1e-2, seed=4)
    got, tl = tloop.incremental_finetune(tm, tp, burst, steps=steps, lr=1e-2, seed=4)
    assert len(rec_j) == len(rec_t) == steps
    for (jpos, jneg), (tpos, tneg) in zip(rec_j, rec_t):
        np.testing.assert_array_equal(tpos, jpos)
        np.testing.assert_array_equal(tneg, jneg)
    rtol = 1e-3 if name == "betae" else 1e-4
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert set(got) == set(want)
    for k in want:
        # The update moves a parameter by at most lr a step; it is held to
        # the family's rtol of that movement on top of rtol of the value.
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol,
                                   atol=rtol * 1e-2 * steps, err_msg=k)


def test_incremental_finetune_leaves_caller_tensors_and_is_deterministic():
    from repro_torch.training import incremental_finetune

    jkg, _, _, tm, tp = _carried("gqe")
    before = {k: v.clone() for k, v in tp.items()}
    burst = jkg.triples[:12]
    a, la = incremental_finetune(tm, tp, burst, steps=8, lr=1e-2, seed=4)
    b, lb = incremental_finetune(tm, tp, burst, steps=8, lr=1e-2, seed=4)
    for k in tp:
        assert torch.equal(tp[k], before[k]), k
        assert a[k] is not tp[k] and torch.equal(a[k], b[k]), k
    assert la == lb and la[-1] < la[0]
    assert incremental_finetune(tm, tp, np.zeros((0, 3)), steps=2) == (tp, [])


# --------------------------------------------------- staleness-bounded serving
def _fresh_setup(name="gqe", n_entities=60, seed=0, **cfg):
    """Per-test graph of each package (live-write tests mutate it) and the
    port's model with the reference's weights."""
    from repro.data import generate_synthetic_kg as j_gen
    from repro.models import ModelConfig as JCfg, make_model as j_make
    from repro_torch.data import generate_synthetic_kg as t_gen
    from repro_torch.models import ModelConfig as TCfg, make_model as t_make
    from repro_torch.models import params_from_numpy

    jkg, tkg = j_gen(n_entities, 4, 300, seed=3), t_gen(n_entities, 4, 300, seed=3)
    jm = j_make(name, JCfg(dim=8, gamma=6.0, **cfg))
    jp = jm.init_params(jax.random.PRNGKey(seed), jkg.n_entities, jkg.n_relations)
    tm = t_make(name, TCfg(dim=8, gamma=6.0, **cfg), device="cpu")
    tp = params_from_numpy(tm, {k: np.asarray(v) for k, v in jp.items()},
                           n_entities=tkg.n_entities)
    return (jkg, jm, jp), (tkg, tm, tp)


def _queries(kg, n=6, seed=0):
    from repro_torch.core import QueryInstance

    rng = np.random.default_rng(seed)
    heads = kg.triples[rng.integers(0, len(kg), n), 0]
    rels = kg.triples[rng.integers(0, len(kg), n), 1]
    return [QueryInstance("1p", np.array([h]), np.array([r]))
            for h, r in zip(heads, rels)]


def _payload(result):
    return {k: v for k, v in result.items() if k not in ("latency_ms", "batch_size")}


def _t_engine(model, params, kg=None, **cfg):
    from repro_torch.core import PooledExecutor
    from repro_torch.serving import ServingConfig, ServingEngine

    base = dict(max_batch=8, max_wait_ms=5.0, top_k=5)
    return ServingEngine(model, params, executor=PooledExecutor(model, b_max=64, device="cpu"),
                         cfg=ServingConfig(**{**base, **cfg}), device="cpu", kg=kg)


def test_stale_pin_is_shed_with_typed_error():
    from repro_torch.serving import StaleVersionError

    _, (kg, model, params) = _fresh_setup()
    with _t_engine(model, params, kg=kg, max_staleness_versions=1) as eng:
        q = _queries(kg, 1)[0]
        assert eng.submit(q, pin_version=0).result(timeout=30)["pattern"] == "1p"
        kg.add_triples([[0, 0, 59]])
        kg.add_triples([[1, 1, 58]])
        assert eng.graph_version == 2
        with pytest.raises(StaleVersionError) as ei:
            eng.submit(q, pin_version=0)
        assert (ei.value.pinned, ei.value.current, ei.value.bound) == (0, 2, 1)
        eng.submit(q, pin_version=1).result(timeout=30)
        with pytest.raises(ValueError, match="unknown graph version"):
            eng.submit(q, pin_version=99)
        st = eng.stats()
    assert st["stale_sheds"] == 1 and st["failures"] == 0
    assert st["graph_version"] == 2 and st["retained_versions"] == [0, 1, 2]
    assert st["version_lag_served"] == {0: 1, 1: 1}


def test_queued_pin_shed_at_execute_time():
    """A pin in bound at admission is shed when writes land while it
    queues (checked again at execute time), typed, never a failure."""
    from repro_torch.serving import StaleVersionError

    _, (kg, model, params) = _fresh_setup()
    eng = _t_engine(model, params, kg=kg, max_staleness_versions=0)
    try:
        f = eng.submit(_queries(kg, 1)[0], pin_version=0)
        kg.add_triples([[0, 0, 59]])
        eng.start()
        with pytest.raises(StaleVersionError):
            f.result(timeout=30)
        assert eng.stats()["stale_sheds"] == 1
    finally:
        eng.close()


def test_pin_version_requires_kg_and_combinations_refused():
    from repro_torch.core import MaterializedSubqueryCache, PooledExecutor
    from repro_torch.serving import ServingConfig, ServingEngine

    _, (kg, model, params) = _fresh_setup()
    with _t_engine(model, params) as eng:
        with pytest.raises(ValueError, match="live graph"):
            eng.submit(_queries(kg, 1)[0], pin_version=0)
    with pytest.raises(ValueError, match="sem_cache"):
        ServingEngine(model, params, device="cpu", kg=kg, sem_cache=object(),
                      sem_rows_fn=lambda ids: ids, started=False)
    with pytest.raises(ValueError, match="pin_params_on_admit"):
        ServingEngine(model, params, device="cpu", kg=kg, started=False,
                      cfg=ServingConfig(pin_params_on_admit=True))
    mat = MaterializedSubqueryCache(8)
    with pytest.raises(ValueError, match="not both"):
        ServingEngine(model, params, device="cpu", mat_cache=mat, started=False,
                      executor=PooledExecutor(model, device="cpu", mat_cache=mat))
    with pytest.raises(ValueError, match="max_staleness"):
        ServingEngine(model, params, device="cpu", kg=kg, started=False,
                      cfg=ServingConfig(max_staleness_versions=-1))


@pytest.mark.parametrize("mat_rows", [0, 32])
def test_pinned_replay_matches_reference_through_writes(mat_rows):
    """A pin at version 0 keeps serving the version-0 params while writes
    and a params update land: bitwise equal to its own first answers and
    to the port's offline oracle, and equal to the JAX package's engine on
    the same weights at the encode tolerance."""
    from repro.core import PooledExecutor as JExecutor
    from repro.serving import ServingConfig as JConfig, ServingEngine as JEngine
    from repro_torch.core import MaterializedSubqueryCache, PooledExecutor
    from repro_torch.launch.serve import serve_batch

    (jkg, jm, jp), (kg, model, params) = _fresh_setup()
    qs = _queries(kg, 6)
    mat = MaterializedSubqueryCache(mat_rows) if mat_rows else None
    if mat is not None:
        mat.watch_kg(kg)
    from repro_torch.serving import ServingConfig, ServingEngine

    eng = ServingEngine(model, params, device="cpu", kg=kg, mat_cache=mat,
                        executor=PooledExecutor(model, b_max=64, device="cpu"),
                        cfg=ServingConfig(max_batch=8, max_wait_ms=5.0, top_k=5,
                                          max_staleness_versions=4))
    jeng = JEngine(jm, jp, executor=JExecutor(jm, b_max=64), kg=jkg,
                   cfg=JConfig(max_batch=8, max_wait_ms=5.0, top_k=5,
                               max_staleness_versions=4))
    with eng, jeng:
        first = [_payload(eng.submit(q, pin_version=0).result(timeout=30)) for q in qs]
        jfirst = [_payload(jeng.submit(q, pin_version=0).result(timeout=30)) for q in qs]
        # Served again before any write: off the cache's rows when it has one.
        assert [_payload(eng.submit(q, pin_version=0).result(timeout=30))
                for q in qs] == first
        for g in (kg, jkg):
            g.add_triples(np.array([[2, 0, 3], [2, 1, 4]]))
        eng.update_params({**eng.params, "entity": eng.params["entity"] * 1.5})
        jeng.update_params({**jeng.params, "entity": jeng.params["entity"] * 1.5})
        unpinned = [_payload(eng.submit(q).result(timeout=30)) for q in qs]
        junpinned = [_payload(jeng.submit(q).result(timeout=30)) for q in qs]
        replay = [_payload(eng.submit(q, pin_version=0).result(timeout=30)) for q in qs]
        st = eng.stats()
    assert replay == first and unpinned != first
    oracle, _ = serve_batch(model, params, PooledExecutor(model, b_max=64, device="cpu"),
                            qs, top_k=5, device="cpu")
    assert first == [_payload(o) for o in oracle]
    for got, want in zip(first + unpinned, jfirst + junpinned):
        assert got["top_entities"] == want["top_entities"]
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=FP32["rtol"],
                                   atol=FP32["atol"] + 1e-3)
    assert st["version_lag_served"] == {0: 18, 1: 6}
    if mat is not None:
        assert st["mat_cache"]["hits"] > 0


def test_pinned_replay_through_entity_growth_keeps_its_mask():
    """With ``entity_pad`` > 1, growth claims pad rows without reallocating;
    a replay pinned to the version before the growth still masks them, as
    the reference's programs traced for that version do."""
    from repro_torch.core import PooledExecutor
    from repro_torch.launch.serve import serve_batch
    from repro_torch.serving import LiveNGDB

    _, (kg, model, params) = _fresh_setup(n_entities=61, entity_pad=8)
    assert params["entity"].shape[0] == 64
    qs = _queries(kg, 6)
    k = 63   # every entity after the growth; before it, 61 real and 2 masked
    with _t_engine(model, params, kg=kg, top_k=k, max_staleness_versions=8) as eng:
        first = [_payload(eng.submit(q, pin_version=0).result(timeout=30)) for q in qs]
        assert all(set(r["top_entities"][:61]) == set(range(61)) for r in first)
        with LiveNGDB(model, kg, eng, finetune_steps=1) as live:
            r = live.write(np.array([[61, 0, 1], [62, 1, 61]]), n_new_entities=2)
            live.flush()
        assert model.n_entities == 63 and eng.params["entity"].shape[0] == 64
        replay = [_payload(eng.submit(q, pin_version=0).result(timeout=30)) for q in qs]
        grown = [_payload(eng.submit(q).result(timeout=30)) for q in qs]
        p_v, n_v = eng.params_at(r.graph_version)
    assert replay == first
    assert all(set(g["top_entities"]) == set(range(63)) for g in grown)
    assert n_v == 63
    oracle, _ = serve_batch(model, p_v, PooledExecutor(model, b_max=64, device="cpu"),
                            qs, top_k=k, device="cpu", n_entities=n_v)
    assert grown == [_payload(o) for o in oracle]


# ------------------------------------------------------------------ LiveNGDB
def _fresh_rows(kg, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        cand = np.stack([rng.integers(0, kg.n_entities, 4 * n),
                         rng.integers(0, kg.n_relations, 4 * n),
                         rng.integers(0, kg.n_entities, 4 * n)], axis=1)
        cand = cand[~kg.contains(cand)]
        out += list(np.unique(cand, axis=0))
    return np.array(out[:n])


def test_live_ngdb_write_burst_serving_continuity():
    from repro_torch.serving import LiveNGDB, WriteReceipt

    _, (kg, model, params) = _fresh_setup()
    qs = _queries(kg, 4)
    with _t_engine(model, params, kg=kg, max_wait_ms=2.0,
                   max_staleness_versions=8) as eng:
        with LiveNGDB(model, kg, eng, finetune_steps=2, seed=0) as live:
            futures = []
            for k in range(6):
                futures += [eng.submit(q) for q in qs]
                r = live.write(np.array([[k, 0, (k + 7) % kg.n_entities],
                                         [k, 1, (k + 9) % kg.n_entities]]))
                assert isinstance(r, WriteReceipt)
            for f in futures:
                assert f.result(timeout=60)["pattern"] == "1p"
            live.flush()
            n_fresh = sum(1 for r in live.receipts if r.n_written)
            assert live.finetunes_done == n_fresh == len(live.finetune_s) > 0
            v, done = kg.graph_version, live.finetunes_done
            prior = next(r for r in live.receipts if r.n_written)
            r = live.write(prior.fresh_triples)
            assert r.n_written == 0 and kg.graph_version == v
            live.flush()
            assert live.finetunes_done == done
            st = eng.stats()
    assert st["failures"] == 0 and st["stale_sheds"] == 0
    assert st["graph_version"] == kg.graph_version


def test_live_ngdb_entity_growth_end_to_end(tmp_path):
    """Growth with a store attached: params, graph and store grow together
    and the new ids are servable at once; old store rows read as before."""
    from repro_torch.core import QueryInstance
    from repro_torch.semantic import SemanticStore, SemanticStoreWriter
    from repro_torch.serving import LiveNGDB

    _, (kg, model, params) = _fresh_setup()
    n0 = kg.n_entities
    w = SemanticStoreWriter(str(tmp_path / "st"), dim=4, shard_rows=16)
    w.append(np.random.default_rng(0).normal(size=(n0, 4)).astype(np.float32))
    w.finalize()
    store = SemanticStore(str(tmp_path / "st"))
    old = store.read_rows(np.arange(n0))
    with _t_engine(model, params, kg=kg, max_staleness_versions=8) as eng:
        with LiveNGDB(model, kg, eng, store=store, finetune_steps=2) as live:
            with pytest.raises(ValueError, match="sem_rows"):
                live.write(np.array([[n0, 0, 1]]), n_new_entities=1)
            rows = np.ones((2, 4), np.float32)
            r = live.write(np.array([[n0, 0, 1], [n0 + 1, 1, n0]]),
                           n_new_entities=2, sem_rows=rows)
            assert r.n_new_entities == 2 and r.n_written == 2
            assert kg.n_entities == model.n_entities == n0 + 2 == store.n_rows
            live.flush()
            q = QueryInstance("1p", np.array([n0]), np.array([0]))
            assert eng.submit(q).result(timeout=30)["anchors"] == [n0]
    np.testing.assert_array_equal(store.read_rows(np.arange(n0)), old)
    np.testing.assert_array_equal(store.read_rows([n0, n0 + 1]), rows)


@pytest.mark.parametrize("name", ["gqe", "betae"])
def test_background_finetune_matches_sync_rerun(name):
    """The maintenance thread's fine-tune is a pure function of (params,
    triples, seed): a synchronous rerun from the recorded inputs reproduces
    the served params bitwise, and the params it started from are left
    unchanged."""
    from repro_torch.serving import LiveNGDB
    from repro_torch.training import incremental_finetune

    _, (kg, model, params) = _fresh_setup(name)
    before = {k: v.clone() for k, v in params.items()}
    burst = _fresh_rows(kg, 3)
    with _t_engine(model, params, kg=kg, max_wait_ms=2.0,
                   max_staleness_versions=8) as eng:
        with LiveNGDB(model, kg, eng, finetune_steps=3, seed=11) as live:
            for q in _queries(kg, 4):
                eng.submit(q)
            r = live.write(burst)
            live.flush()
            served = eng.params
    sync, losses = incremental_finetune(model, params, r.fresh_triples, steps=3,
                                        lr=live.finetune_lr,
                                        n_negatives=live.n_negatives,
                                        seed=11 + r.graph_version)
    assert set(served) == set(sync)
    for k in served:
        assert torch.equal(served[k], sync[k]), k
        assert torch.equal(params[k], before[k]), k
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_live_ngdb_surfaces_background_errors():
    from repro_torch.serving import LiveNGDB

    _, (kg, model, params) = _fresh_setup()
    with _t_engine(model, params, kg=kg, max_staleness_versions=8) as eng:
        live = LiveNGDB(model, kg, eng, finetune_steps=1)
        eng.params = {k: v for k, v in eng.params.items() if k != "relation"}
        live.write(_fresh_rows(kg, 2))
        with pytest.raises(KeyError):
            live.flush()
        live.close(flush=False)


def test_cli_live_writes_and_materialize_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--model", "gqe", "--reduced", "--device", "cpu", "--dim", "8",
          "--requests", "48", "--materialize", "128", "--live-writes", "3",
          "--max-staleness", "4", "--max-wait-ms", "1000"])
    out = capsys.readouterr().out
    assert "live writes: 3 bursts" in out and "3 background fine-tunes" in out
    assert "materialized rows: hit rate" in out and "0 stale sheds" in out
