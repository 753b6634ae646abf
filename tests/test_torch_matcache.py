"""The port's materialized-subquery cache against the JAX package's
(``repro.core.matcache``), and its use by the executor, the serving engine
and the trainer (``TrainConfig(materialized_rows>0)``)."""
import numpy as np
import pytest
import torch

from test_torch_models import FAMILIES
from torch_parity import carried_models, graphs, queries

torch.set_num_threads(1)


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return [("q", int(k)) for k in rng.integers(0, n, size=8)]


@pytest.mark.parametrize("budget", [4, 16])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_op_sequence_matches_reference(seed, budget):
    """One seeded interleaving of inserts (current and pinned versions),
    lookups, probes and bumps: every hit set, returned row, counter and slot
    owner equals the reference cache's."""
    from repro.core.matcache import MaterializedSubqueryCache as JCache
    from repro_torch.core import MaterializedSubqueryCache as TCache

    j, t = JCache(budget, name=f"j{seed}"), TCache(budget, name=f"t{seed}")
    rng = np.random.default_rng(seed)
    for step in range(120):
        op = ("insert", "insert", "lookup", "lookup", "probe", "bump",
              "pinned")[int(rng.integers(7))]
        keys = _keys(3 * budget, 1000 * seed + step)
        if op == "insert":
            rows = rng.normal(size=(len(keys), 6)).astype(np.float32)
            assert t.insert(keys, torch.from_numpy(rows)) == j.insert(keys, rows)
        elif op == "lookup":
            want = j.lookup(keys)
            got = t.lookup(keys)
            assert sorted(got) == sorted(want)
            for i, row in want.items():
                np.testing.assert_array_equal(got[i].numpy(), row)
        elif op == "probe":
            assert t.probe(keys) == j.probe(keys)
        elif op == "bump":
            assert t.bump_version("test") == j.bump_version("test")
        else:   # an insert computed under the version before a bump
            v = j.version
            j.bump_version("pin")
            t.bump_version("pin")
            rows = np.zeros((len(keys), 6), np.float32)
            assert t.insert(keys, rows, version=v) == j.insert(keys, rows, version=v) == 0
        assert t._owner == list(j._owner)
    js, ts = j.stats(), t.stats()
    for k in ("resident", "live", "version", "hits", "misses", "probe_hits",
              "probe_misses", "inserts", "evictions", "invalidations",
              "stale_drops", "invalidation_reasons"):
        assert ts[k] == js[k], k
    t.check_consistent()


def test_insert_at_pinned_version_drops_after_bump():
    from repro_torch.core import MaterializedSubqueryCache

    mat = MaterializedSubqueryCache(8)
    rows = torch.ones((2, 4))
    v = mat.version
    assert mat.insert([("a",), ("b",)], rows, version=v) == 2
    assert len(mat.lookup([("a",), ("b",)])) == 2
    mat.bump_version("param_update")
    assert mat.insert([("c",)], rows[:1], version=v) == 0
    assert mat.stats()["stale_drops"] == 1
    assert mat.lookup([("c",)]) == {}
    assert mat.lookup([("a",), ("b",)]) == {}


def test_lookup_is_a_copy_a_later_insert_cannot_tear():
    from repro_torch.core import MaterializedSubqueryCache

    mat = MaterializedSubqueryCache(1)
    mat.insert([("a",)], torch.full((1, 3), 1.0))
    held = mat.lookup([("a",)])[0]
    mat.bump_version()
    mat.insert([("b",)], torch.full((1, 3), 2.0))   # reuses the one slot
    assert mat._owner == [("b",)]
    np.testing.assert_array_equal(held.numpy(), np.ones(3, np.float32))


def test_duplicate_keys_in_one_insert_keep_the_last_row():
    from repro.core.matcache import MaterializedSubqueryCache as JCache
    from repro_torch.core import MaterializedSubqueryCache as TCache

    rows = np.arange(12, dtype=np.float32).reshape(4, 3)
    keys = [("a",), ("b",), ("a",), ("c",)]
    j, t = JCache(2), TCache(2)
    assert t.insert(keys, torch.from_numpy(rows)) == j.insert(keys, rows)
    assert t._owner == list(j._owner)
    want, got = j.lookup([("a",), ("b",), ("c",)]), t.lookup([("a",), ("b",), ("c",)])
    assert sorted(got) == sorted(want)
    for i, row in want.items():
        np.testing.assert_array_equal(got[i].numpy(), row)


def test_watch_kg_bumps_on_writes_and_is_held_weakly():
    import gc

    from repro_torch.core import MaterializedSubqueryCache
    from repro_torch.data import generate_synthetic_kg

    kg = generate_synthetic_kg(50, 4, 300, seed=1)
    mat = MaterializedSubqueryCache(4)
    mat.watch_kg(kg)
    kg.add_triples(kg.triples[:3])                 # no-op: nothing fires
    assert mat.version == 0
    kg.add_entities(2)
    assert mat.version == 1
    assert mat.stats()["invalidation_reasons"] == {"entity_add": 1}
    assert kg.live_listener_count() == 1
    del mat
    gc.collect()
    assert kg.live_listener_count() == 0
    kg.add_entities(1)                             # prunes, fires nothing


def _scaled(params, f):
    return {k: (v * f if v.is_floating_point() else v) for k, v in params.items()}


# Families whose cached rows are bitwise a fresh encode on the CPU. The
# others project with plain torch.matmul, whose rows differ with the pool's
# row count by up to 1.2e-7 here (ROADMAP Queue 3, stated deviations): they
# are held to the encode tolerance.
BITWISE_ROWS = ("gqe", "complex")


@pytest.mark.parametrize("name", ["betae", "gqe", "complex", "q2b", "q2p", "fuzzqe"])
def test_materialized_rows_never_stale(name):
    """Under a seeded interleaving of {encode, param update, graph write,
    eviction pressure, pinned insert}, the cached encode equals a fresh
    no-cache encode — bitwise for ``BITWISE_ROWS``, at the encode tolerance
    for the rest. A row served stale (old params or old graph) is off by far
    more than either."""
    from torch_parity import ENCODE

    from repro_torch.core import MaterializedSubqueryCache, PooledExecutor
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.sampling import OnlineSampler

    kg = generate_synthetic_kg(80, 6, 600, seed=3)
    model = make_model(name, ModelConfig(dim=8, gamma=6.0), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0), kg.n_entities,
                               kg.n_relations)
    mat = MaterializedSubqueryCache(24)
    mat.watch_kg(kg)
    ex = PooledExecutor(model, b_max=32, device="cpu", mat_cache=mat)
    oracle = PooledExecutor(model, b_max=32, device="cpu")
    pool = [s.query for s in OnlineSampler(kg, seed=11).sample_batch(40)]
    rng = np.random.default_rng(7)
    ops = ("encode", "encode", "param_update", "kg_write", "evict_pressure", "pin")
    for step in range(40):
        op = "encode" if step == 0 else ops[int(rng.integers(len(ops)))]
        if op == "encode":
            qs = [pool[i] for i in rng.integers(len(pool), size=8)]
            got, want = ex.encode(params, qs).numpy(), oracle.encode(params, qs).numpy()
            if name in BITWISE_ROWS:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, **ENCODE)
        elif op == "param_update":
            params = _scaled(params, 1.001)
            mat.bump_version("param_update")
        elif op == "kg_write":
            v0 = mat.version
            kg.add_triples([[int(rng.integers(80)), int(rng.integers(6)),
                             int(rng.integers(80))]])
            assert mat.version == v0 + 1
        elif op == "evict_pressure":
            idx = rng.choice(len(pool), size=30, replace=False)
            ex.encode(params, [pool[i] for i in idx])
        else:
            v = mat.version
            mat.bump_version("test_pin")
            assert mat.insert([("bogus",)], torch.zeros((1, model.state_dim)),
                              version=v) == 0
            assert mat.lookup([("bogus",)]) == {}
    mat.check_consistent()
    st = mat.stats()
    assert st["invalidations"] > 0 and st["hits"] > 0
    assert ex.sharing_stats()["materialized"]["hits"] == st["hits"]


@pytest.mark.parametrize("name", FAMILIES)
def test_cached_encode_matches_reference_rows(name):
    """Rows served from the port's cache (a second encode of the same
    queries) against the JAX package's no-cache encode on the same weights."""
    from repro.core import PooledExecutor as JExecutor
    from repro_torch.core import MaterializedSubqueryCache, PooledExecutor
    from torch_parity import ENCODE

    jm, jp, tm, tp = carried_models(name)
    jq, tq = queries(12, seed=4)
    mat = MaterializedSubqueryCache(64)
    ex = PooledExecutor(tm, b_max=16, device="cpu", mat_cache=mat)
    first = ex.encode(tp, tq).numpy()
    again = ex.encode(tp, tq).numpy()
    assert mat.stats()["hits"] == len(set(q.key() for q in tq))
    np.testing.assert_array_equal(again, first)
    want = np.asarray(JExecutor(jm, b_max=16).encode(jp, jq))
    np.testing.assert_allclose(again, want, **ENCODE)


def _batches(kg, n, size, seed):
    from repro_torch.sampling import OnlineSampler

    s = OnlineSampler(kg, seed=seed)
    return [s.sample_batch(size) for _ in range(n)]


@pytest.mark.parametrize("pipeline", [False, True])
def test_trainer_materialized_rows(pipeline):
    """``TrainConfig(materialized_rows>0)`` trains (sync and pipelined) with
    losses bitwise those of a trainer without the cache, bumps the cache
    after every step, and ``evaluate`` through the cached executor equals
    the uncached one."""
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.training import NGDBTrainer, TrainConfig, evaluate

    _, kg = graphs()
    batches = _batches(kg, 3, 24, seed=5)
    runs = {}
    for rows in (0, 64):
        model = make_model("gqe", ModelConfig(dim=8), device="cpu")
        cfg = TrainConfig(batch_size=24, n_negatives=4, b_max=64, prefetch=0,
                          pipeline=pipeline, materialized_rows=rows)
        tr = NGDBTrainer(model, kg, cfg)
        hist = tr.train(6, log_every=0, batches=batches)
        runs[rows] = (tr, [h["loss"] for h in hist])
    tr, losses = runs[64]
    assert losses == runs[0][1]
    st = tr.mat_cache.stats()
    assert st["invalidations"] == 6
    assert st["invalidation_reasons"] == {"param_update": 6}
    if pipeline:
        # The scheduler thread may have prepared items past the last step.
        probed = st["probe_hits"] + st["probe_misses"]
        assert probed >= 6 * 24 and probed % 24 == 0
    evq = [s.query for b in _batches(kg, 1, 32, seed=9) for s in b]
    plain = evaluate(runs[0][0].model, runs[0][0].params, runs[0][0].executor, kg, evq,
                     batch_size=16)
    cached = evaluate(tr.model, tr.params, tr.executor, kg, evq, batch_size=16)
    again = evaluate(tr.model, tr.params, tr.executor, kg, evq, batch_size=16)
    assert cached == plain == again
    assert tr.mat_cache.stats()["hits"] > 0
    kg_v = tr.mat_cache.version
    tr.kg.add_entities(0)           # a no-op write bumps nothing
    assert tr.mat_cache.version == kg_v


def test_trainer_still_refuses_later_slices(tmp_path):
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.obs import read_jsonl
    from repro_torch.training import NGDBTrainer, TrainConfig

    _, kg = graphs()
    model = make_model("gqe", ModelConfig(dim=8), device="cpu")
    # metrics_path came with slice 6: beside a mat cache it writes the records.
    path = tmp_path / "m.jsonl"
    tr = NGDBTrainer(model, kg, TrainConfig(batch_size=8, n_negatives=2, b_max=32,
                                            prefetch=0, materialized_rows=8,
                                            metrics_path=str(path)))
    tr.train(1, log_every=0)
    assert [r["kind"] for r in read_jsonl(str(path))] == ["step"]
    with pytest.raises(NotImplementedError, match="slice 9"):
        NGDBTrainer(model, kg, TrainConfig(), ctx=object())
