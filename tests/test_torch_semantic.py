"""The port's semantic slice against the JAX package: the stub PTE and its
descriptions, the precompute, the on-disk store in both directions, the
hot-set cache's CLOCK accounting, and the semantic branch of the models
(``fused_entity_vec``, ``score_all``, ``score_all_chunked``) on shared
weights, in both layouts."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import BETAE_DISTANCE, ENCODE, FAMILIES, FP32, graphs

torch.set_num_threads(1)

# The JAX package's store-test encoder (tests/test_semantic_store.py).
SMALL = dict(d_l=16, n_layers=1, d_model=32, n_heads=2)


def _pte_pair(**cfg):
    """The JAX stub encoder and the port's, carrying the same weights."""
    from repro.semantic import PTEConfig as JCfg, StubPTE as JPTE
    from repro_torch.semantic import PTEConfig as TCfg, StubPTE as TPTE

    jpte = JPTE(JCfg(**cfg))
    tpte = TPTE(TCfg(**cfg), device="cpu",
                params={k: np.asarray(v) for k, v in jpte.params.items()})
    return jpte, tpte


@pytest.fixture(scope="module")
def table():
    """The port's in-memory H_sem of the shared graph (small encoder)."""
    from repro_torch.semantic import precompute_semantic_table

    _, tpte = _pte_pair(**SMALL)
    return precompute_semantic_table(graphs()[1], tpte)


# ------------------------------------------------------------ encoder side
def test_relations_by_head_equal():
    jkg, tkg = graphs()
    for a, b in zip(jkg.relations_by_head, tkg.relations_by_head):
        np.testing.assert_array_equal(a, b)


def test_descriptions_equal():
    from repro.semantic import StubPTE as JPTE
    from repro_torch.semantic import StubPTE as TPTE

    jkg, tkg = graphs()
    ids = np.concatenate([np.arange(tkg.n_entities), [0, 5, 5, 199]])
    np.testing.assert_array_equal(TPTE.descriptions(tkg, ids),
                                  JPTE.descriptions(jkg, ids))


@pytest.mark.parametrize("cfg", ["small", "full"])
def test_encode_tokens_matches_reference(cfg):
    """Full is PTEConfig() itself: d_model 256, 4 layers, 4 heads, d_l 1024."""
    jpte, tpte = _pte_pair(**(SMALL if cfg == "small" else {}))
    assert {k for k, _ in tpte.named_parameters()} == set(jpte.params)
    toks = jpte.descriptions(graphs()[0], np.arange(0, 200, 7))
    want = np.asarray(jpte.encode_tokens(jnp.asarray(toks)))
    got = tpte.encode_tokens(toks).numpy()
    np.testing.assert_allclose(got, want, **ENCODE)


def test_port_pte_draws_its_own_weights_and_unloads():
    from repro_torch.semantic import PTEConfig, StubPTE

    a = StubPTE(PTEConfig(**SMALL), device="cpu")
    b = StubPTE(PTEConfig(**SMALL), device="cpu")
    toks = StubPTE.descriptions(graphs()[1], np.arange(10))
    assert torch.equal(a.encode_tokens(toks), b.encode_tokens(toks))  # seeded
    a.unload()
    assert a.unloaded and not list(a.parameters())
    with pytest.raises(RuntimeError, match="unloaded"):
        a.encode_tokens(toks)


def test_precompute_matches_reference_on_carried_weights():
    from repro.semantic import precompute_semantic_table as j_pre
    from repro_torch.semantic import precompute_semantic_table as t_pre

    jpte, tpte = _pte_pair(**SMALL)
    jkg, tkg = graphs()
    np.testing.assert_allclose(t_pre(tkg, tpte), j_pre(jkg, jpte), **ENCODE)
    assert tpte.unloaded


# -------------------------------------------------------------------- store
def _port_store(directory, quant="fp32"):
    from repro_torch.semantic import precompute_semantic_table_to_store

    _, tpte = _pte_pair(**SMALL)
    return precompute_semantic_table_to_store(graphs()[1], str(directory),
                                              tpte, shard_rows=64, quant=quant)


def test_streaming_store_bitwise_matches_in_memory(table, tmp_path):
    store = _port_store(tmp_path)
    assert store.n_rows == 200 and store.dim == SMALL["d_l"]
    np.testing.assert_array_equal(store.read_rows(np.arange(200)), table)
    ids = np.array([150, 3, 64, 63, 199, 0])
    np.testing.assert_array_equal(store.read_rows(ids), table[ids])
    assert [lo for lo, _ in store.iter_shards()] == [0, 64, 128, 192]
    np.testing.assert_array_equal(
        np.concatenate([rows for _, rows in store.iter_shards()]), table)
    assert sorted(os.listdir(tmp_path)) == (
        ["meta.json"] + [f"shard_{i:05d}.bin" for i in range(4)])


def test_int8_store_within_bound(table, tmp_path):
    store = _port_store(tmp_path, quant="int8")
    bound = np.abs(table).max(axis=1, keepdims=True) / 254.0 + 1e-7
    assert (np.abs(store.read_rows(np.arange(200)) - table) <= bound).all()
    assert store.disk_nbytes < 200 * SMALL["d_l"] * 4 / 3


@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_reference_store_read_by_port(tmp_path, quant):
    from repro.semantic import SemanticStoreWriter as JWriter
    from repro.semantic import SemanticStore as JStore
    from repro_torch.semantic import SemanticStore as TStore

    rows = np.random.default_rng(3).normal(size=(150, 24)).astype(np.float32)
    w = JWriter(str(tmp_path), 24, quant=quant, shard_rows=64)
    w.append(rows[:100])
    w.append(rows[100:])
    w.finalize()
    ids = np.random.default_rng(4).integers(0, 150, size=80)
    got = TStore(str(tmp_path))
    assert (got.n_rows, got.dim, got.quant) == (150, 24, quant)
    want = JStore(str(tmp_path)).read_rows(ids)
    np.testing.assert_array_equal(got.read_rows(ids), want)


@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_port_store_opened_by_reference(tmp_path, quant):
    from repro.semantic import SemanticStore as JStore

    store = _port_store(tmp_path, quant=quant)
    ids = np.arange(200)[::-3]
    ref = JStore(str(tmp_path))
    assert ref.disk_nbytes == store.disk_nbytes
    np.testing.assert_array_equal(ref.read_rows(ids), store.read_rows(ids))


def test_partial_store_rejected(tmp_path):
    from repro_torch.semantic import SemanticStore, SemanticStoreError

    _port_store(tmp_path)
    shard = tmp_path / "shard_00001.bin"
    payload = shard.read_bytes()
    shard.write_bytes(payload[:-16])
    with pytest.raises(SemanticStoreError, match="partial shard"):
        SemanticStore(str(tmp_path))
    shard.write_bytes(payload)
    SemanticStore(str(tmp_path))  # restored -> opens again
    shard.unlink()
    with pytest.raises(SemanticStoreError, match="missing shard"):
        SemanticStore(str(tmp_path))


def test_unfinished_or_rebuilt_store_does_not_open(tmp_path):
    from repro_torch.semantic import (SemanticStore, SemanticStoreError,
                                      SemanticStoreWriter)

    w = SemanticStoreWriter(str(tmp_path), dim=8, shard_rows=4)
    w.append(np.ones((8, 8), np.float32))
    w.finalize()
    SemanticStore(str(tmp_path))
    # A rebuild that crashes after one shard leaves nothing openable.
    SemanticStoreWriter(str(tmp_path), dim=8, shard_rows=4).append(
        np.zeros((4, 8), np.float32))
    with pytest.raises(SemanticStoreError, match="missing meta"):
        SemanticStore(str(tmp_path))
    with pytest.raises(SemanticStoreError, match="quant"):
        SemanticStoreWriter(str(tmp_path), dim=8, quant="fp16")


# -------------------------------------------------------------------- cache
def _caches(table, budget):
    from repro.semantic import SemanticCache as JCache
    from repro_torch.semantic import SemanticCache as TCache

    return JCache(table, budget_rows=budget), TCache(table, budget_rows=budget,
                                                     device="cpu")


def test_cache_clock_accounting_matches_reference(table):
    """The same id sequence through both caches: equal hit/miss/eviction
    counts and residency after every plan, and staged rows that read back."""
    jc, tc = _caches(table, 24)
    jp = {"sem_cache": jc.buffer, "sem_slot": jc.slot_map}
    tp = {"sem_cache": tc.buffer, "sem_slot": tc.slot_map}
    rng = np.random.default_rng(5)
    for step in range(12):
        ids = rng.integers(0, 200, size=rng.integers(1, 20))
        if step % 4 == 3:
            ids = np.concatenate([ids, ids[:3]])  # duplicates count once
        js, ts = jc.plan(ids), tc.plan(ids)
        assert (js is None) == (ts is None)
        if ts is not None:
            assert ts.n_rows == js.n_rows
            jp = jc.apply_to(jp, js)
            tp = tc.apply_to(tp, ts)
        assert (int(tc.hits), int(tc.misses), int(tc.evictions)) == (
            int(jc.hits), int(jc.misses), int(jc.evictions))
        np.testing.assert_array_equal(tc.resident_ids(), jc.resident_ids())
        np.testing.assert_array_equal(tp["sem_slot"].numpy(),
                                      np.asarray(jp["sem_slot"]))
        got = tp["sem_cache"][tp["sem_slot"][torch.from_numpy(ids)]].numpy()
        np.testing.assert_array_equal(got, table[ids])
    assert tc.evictions > 0
    ts, js = tc.stats(), jc.stats()
    # Every reference key, background staging's three counters included.
    assert set(js) == set(ts)
    assert ts == {**js, "hit_rate": pytest.approx(js["hit_rate"])}
    tc.reset_counters()
    assert (tc.hits, tc.misses, tc.resident_rows) == (0, 0, 24)


def test_cache_rejects_oversized_working_set(table):
    _, tc = _caches(table, 4)
    with pytest.raises(RuntimeError, match="budget"):
        tc.plan(np.arange(5))


def test_stage_apply_out_of_order_rejected(table):
    _, tc = _caches(table, 8)
    params = {"sem_cache": tc.buffer, "sem_slot": tc.slot_map}
    s1 = tc.plan(np.array([0, 1]))
    s2 = tc.plan(np.array([2, 3]))
    with pytest.raises(RuntimeError, match="out of order"):
        tc.apply_to(params, s2)
    tc.apply_to(params, s1)
    tc.reconcile()  # s2 planned but dropped -> residency reset
    assert tc.resident_rows == 0


# ------------------------------------------------------------------- models
SEM_CFG = dict(dim=16, semantic_dim=SMALL["d_l"], semantic_proj_dim=8)


def _models(name, table, budget=None, stage_ids=None, cfg=SEM_CFG):
    """The JAX model's semantic params at ``cfg`` (resident, or through a JAX
    cache that staged ``stage_ids``) carried into the port's model on the
    CPU."""
    from repro.models import ModelConfig as JCfg, make_model as j_make
    from repro.semantic import SemanticCache as JCache
    from repro_torch.models import (ModelConfig as TCfg, make_model as t_make,
                                    params_from_numpy)

    jkg, _ = graphs()
    jm = j_make(name, JCfg(**cfg))
    if budget is None:
        jp = jm.init_params(jax.random.PRNGKey(0), jkg.n_entities,
                            jkg.n_relations, semantic_table=table)
    else:
        cache = JCache(table, budget_rows=budget)
        jp = jm.init_params(jax.random.PRNGKey(0), jkg.n_entities,
                            jkg.n_relations, semantic_cache=cache)
        jp = cache.apply_to(jp, cache.plan(stage_ids))
    tm = t_make(name, TCfg(**cfg), device="cpu")
    tp = params_from_numpy(tm, {k: np.asarray(v) for k, v in jp.items()})
    return jm, jp, tm, tp


def _tol(name):
    return BETAE_DISTANCE if name == "betae" else FP32


@pytest.mark.parametrize("layout", ["resident", "cache"])
@pytest.mark.parametrize("name", FAMILIES)
def test_fused_entity_vec_and_embed_match_reference(name, layout, table):
    ids = np.random.default_rng(6).integers(0, 200, size=(4, 6))
    jm, jp, tm, tp = _models(name, table, *(
        () if layout == "resident" else (48, ids.ravel())))
    if layout == "cache":
        assert tp["sem_slot"].dtype == torch.int32
        assert set(tp) >= {"sem_cache", "sem_slot"} and "sem_table" not in tp
    with torch.no_grad():
        got = tm.fused_entity_vec(tp, torch.from_numpy(ids)).numpy()
        emb = tm.embed(tp, torch.from_numpy(ids[0])).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.fused_entity_vec(jp, ids)), **FP32)
    np.testing.assert_allclose(emb, np.asarray(jm.embed(jp, jnp.asarray(ids[0]))), **FP32)


@pytest.mark.parametrize("name", FAMILIES)
def test_score_all_and_chunked_match_reference(name, table):
    jm, jp, tm, tp = _models(name, table)
    ids = np.arange(0, 200, 23)
    jq = jm.embed(jp, jnp.asarray(ids))
    with torch.no_grad():
        tq = tm.embed(tp, torch.from_numpy(ids))
        dense = tm.score_all(tp, tq).numpy()
    want = np.asarray(jm.score_all(jp, jq))
    np.testing.assert_allclose(dense, want, **_tol(name))
    rows_fn = lambda i: table[np.asarray(i)]  # noqa: E731
    chunked = tm.score_all_chunked(tp, tq, rows_fn, chunk=64)
    np.testing.assert_allclose(
        chunked, jm.score_all_chunked(jp, jq, rows_fn, chunk=64), **_tol(name))
    np.testing.assert_allclose(chunked, dense, **FP32)


def test_score_all_refuses_cache_params(table):
    _, _, tm, tp = _models("gqe", table, 32, np.arange(10))
    with torch.no_grad(), pytest.raises(RuntimeError, match="score_all_chunked"):
        tm.score_all(tp, tm.embed(tp, torch.arange(4)))


def test_semantic_init_params_shapes_match_reference(table):
    """The port's own init at the reference's shapes, in both layouts; the
    semantic buffers are frozen buffers, the fusion weights parameters."""
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.semantic import SemanticCache

    jm, jp, _, _ = _models("gqe", table)
    tm = make_model("gqe", ModelConfig(**SEM_CFG, entity_pad=16), device="cpu")
    tp = tm.init_params(torch.Generator().manual_seed(0), 200, 10,
                        semantic_table=table)
    assert tp["sem_table"].shape == (208, SMALL["d_l"])
    assert not tp["sem_table"][200:].any()
    assert tp["entity"].shape == (208, 16)
    padded = ("entity", "sem_table")
    assert {k: tuple(v.shape) for k, v in tp.items() if k not in padded} == {
        k: tuple(v.shape) for k, v in jp.items() if k not in padded}
    assert {k for k, _ in tm.named_buffers()} == {"sem_table"}
    cache = SemanticCache(table, budget_rows=32, device="cpu")
    tp = tm.init_params(torch.Generator().manual_seed(0), 200, 10,
                        semantic_cache=cache)
    assert tp["sem_cache"] is cache.buffer and tp["sem_slot"] is cache.slot_map
    assert {k for k, _ in tm.named_buffers()} == {"sem_cache", "sem_slot"}
