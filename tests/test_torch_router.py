"""The port's replica tier against the JAX package: topology keys and
rendezvous placement (exact), the router's spill and shed decisions on stub
replicas (exact), and hot swap on a real pool, held to the offline oracle."""
import queue as queue_mod
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from torch_parity import FP32, graphs, queries

torch.set_num_threads(1)


def test_topology_keys_match_reference():
    from repro.serving import query_topology_key as j_key
    from repro_torch.serving import query_topology_key as t_key

    jq, tq = queries(60, seed=5)
    for a, b in zip(jq, tq):
        assert t_key(b) == j_key(a)


@pytest.mark.parametrize("rids", [[0, 1], [0, 1, 2, 3], [3, 7, 9, 11, 12]])
def test_rendezvous_rank_matches_reference(rids):
    from repro.serving import query_topology_key, rendezvous_rank as j_rank
    from repro_torch.serving import rendezvous_rank as t_rank

    jq, _ = queries(40, seed=6)
    topos = [query_topology_key(q) for q in jq] + [((i, i + 1), (0,)) for i in range(50)]
    for topo in topos:
        assert t_rank(topo, rids) == j_rank(topo, rids)
        assert t_rank(topo, rids[::-1]) == t_rank(topo, rids)


def test_rendezvous_remap_fraction_on_join_and_leave():
    from repro_torch.serving import rendezvous_rank

    topos = [((i, i + 1), (0,)) for i in range(200)]
    before = {t: rendezvous_rank(t, [0, 1, 2, 3])[0] for t in topos}
    after_join = {t: rendezvous_rank(t, [0, 1, 2, 3, 4])[0] for t in topos}
    moved = [t for t in topos if before[t] != after_join[t]]
    assert all(after_join[t] == 4 for t in moved)
    assert len(moved) / len(topos) < 2 / 5
    after_leave = {t: rendezvous_rank(t, [0, 1, 3])[0] for t in topos}
    for t in topos:
        if before[t] != 2:
            assert after_leave[t] == before[t]


# ---------------------------------------------------------------------------
# Spill + tenant admission against stub pools (exact queue-depth control)
# ---------------------------------------------------------------------------

class StubReplica:
    def __init__(self):
        self.depth = 0
        self.full = False
        self.submitted = []

    def queue_depth(self):
        return self.depth

    def submit(self, q, top_k=None, timeout=None):
        if self.full:
            raise queue_mod.Full()
        f = Future()
        self.submitted.append((q, f, timeout))
        return f


class StubPool:
    def __init__(self, n):
        self._reps = {i: StubReplica() for i in range(n)}
        self.membership_token = 0

    def replicas(self):
        return dict(self._reps)

    def stats(self):
        return {}

    def update_params(self, params):
        pass

    def close(self, **kw):
        pass


def _stub_routers():
    from repro.serving import Router as JRouter, RouterConfig as JCfg, TenantSpec as JSpec
    from repro_torch.serving import Router as TRouter, RouterConfig as TCfg
    from repro_torch.serving import TenantSpec as TSpec

    out = []
    for R, C, S in ((JRouter, JCfg, JSpec), (TRouter, TCfg, TSpec)):
        pool = StubPool(4)
        router = R(pool, tenants=[S("gold", "high"), S("bronze", "low"),
                                  S("capped", "high", max_inflight=3)],
                   cfg=C(spill_depth=4, spill_width=1))
        out.append((pool, router))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_spill_and_shed_decisions_match_reference(seed):
    """One seeded sequence of queue depths, full queues, tenants and
    completions on stub pools: every placement, spill, shed (with its
    reason) and quota release is the reference router's."""
    from repro.serving import ShedError as JShed
    from repro_torch.serving import ShedError as TShed

    (jpool, jr), (tpool, tr) = _stub_routers()
    jq, tq = queries(30, seed=7)
    rng = np.random.default_rng(seed)
    for step in range(80):
        i = int(rng.integers(len(jq)))
        for rid in range(4):
            d, full = int(rng.integers(0, 8)), bool(rng.random() < 0.15)
            for pool in (jpool, tpool):
                pool._reps[rid].depth, pool._reps[rid].full = d, full
        tenant = ("gold", "bronze", "capped")[int(rng.integers(3))]
        outcome = []
        for router, pool, q, Shed in ((jr, jpool, jq[i], JShed), (tr, tpool, tq[i], TShed)):
            before = {rid: len(r.submitted) for rid, r in pool._reps.items()}
            try:
                router.submit(q, tenant=tenant)
                placed = [rid for rid, r in pool._reps.items()
                          if len(r.submitted) > before[rid]]
                outcome.append(("admitted", placed))
            except Shed as e:
                outcome.append(("shed", e.reason))
            except queue_mod.Full:
                outcome.append(("full", None))
        assert outcome[0] == outcome[1], (step, outcome)
        if rng.random() < 0.3:      # complete the oldest open request of each
            for pool in (jpool, tpool):
                for r in pool._reps.values():
                    open_ = [f for _, f, _ in r.submitted if not f.done()]
                    if open_:
                        open_[0].set_result({"latency_ms": 1.0})
                        break
    js, ts = jr.stats(), tr.stats()
    for k in ("routed", "spilled", "shed"):
        assert ts[k] == js[k], k
    for name in ("gold", "bronze", "capped"):
        for k in ("inflight", "submitted", "completed", "failures", "shed"):
            assert ts["tenants"][name][k] == js["tenants"][name][k], (name, k)


def test_low_priority_shed_never_blocks_and_quota_releases():
    from repro_torch.serving import ShedError

    (_, _), (pool, router) = _stub_routers()
    _, qs = queries(30, seed=7)
    q = qs[0]
    rank = router._ranking(router._topology(q))
    for rid in rank[:2]:
        pool._reps[rid].depth = 5
    t0 = time.perf_counter()
    with pytest.raises(ShedError) as ei:
        router.submit(q, tenant="bronze")
    assert ei.value.reason == "backpressure" and time.perf_counter() - t0 < 0.1
    for rid in rank[:2]:
        pool._reps[rid].depth, pool._reps[rid].full = 0, True
    with pytest.raises(ShedError):
        router.submit(q, tenant="bronze")
    for rid in rank[:2]:
        pool._reps[rid].full = False
    futs = [router.submit(qs[i], tenant="capped") for i in range(3)]
    with pytest.raises(ShedError) as ei:
        router.submit(qs[3], tenant="capped")
    assert ei.value.reason == "quota" and router.tenant_inflight("capped") == 3
    futs[0].set_result({"latency_ms": 1.0})
    assert router.tenant_inflight("capped") == 2
    router.submit(qs[3], tenant="capped")
    with pytest.raises(KeyError):
        router.submit(q, tenant="nobody")
    st = router.stats()
    assert st["tenants"]["bronze"]["shed"]["backpressure"] == 2
    assert st["tenants"]["capped"]["shed"]["quota"] == 1


def test_membership_change_invalidates_ranking():
    (_, _), (pool, router) = _stub_routers()
    _, qs = queries(30, seed=7)
    r0 = router._ranking(router._topology(qs[0]))
    del pool._reps[r0[0]]
    pool.membership_token += 1
    r1 = router._ranking(router._topology(qs[0]))
    assert r0[0] not in r1 and r1 == [rid for rid in r0 if rid != r0[0]]


# ---------------------------------------------------------------------------
# Real pool: routing parity, hot swap, labels
# ---------------------------------------------------------------------------

def _served():
    from repro_torch.models import ModelConfig, make_model

    _, kg = graphs()
    model = make_model("gqe", ModelConfig(dim=16, gamma=6.0), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0), kg.n_entities,
                               kg.n_relations)
    return kg, model, params


def _oracle(model, params):
    from repro_torch.core import PooledExecutor
    from repro_torch.launch.serve import serve_batch

    ex = PooledExecutor(model, b_max=256, device="cpu")
    return lambda qs: serve_batch(model, params, ex, qs, device="cpu")[0]


def _cfg(**kw):
    from repro_torch.serving import ServingConfig

    return ServingConfig(**{"max_batch": 8, "max_wait_ms": 1000.0, **kw})


def test_router_parity_and_hot_swap_matches_fresh_pool():
    """A pool of two replicas behind the router replays bitwise through the
    offline oracle; after a hot swap every batch replays on the NEW params
    and the results equal a fresh pool's on them."""
    from repro_torch.serving import (ReplicaPool, Router, check_against_offline,
                                     make_workload, run_closed_loop)

    kg, model, params = _served()
    params_b = model.init_params(torch.Generator().manual_seed(7), kg.n_entities,
                                 kg.n_relations)
    qs = make_workload(kg, 24, seed=13)
    cfg = _cfg(record_batches=True)
    pool = ReplicaPool(model, params, n_replicas=2, cfg=cfg, mat_budget_rows=64,
                       device="cpu")
    with Router(pool) as router:
        run_closed_loop(router, qs, concurrency=8)
        serve_fn = _oracle(model, params)
        checked = sum(check_against_offline(r.engine.batch_log, serve_fn)
                      for r in pool.replicas().values())
        assert checked >= len(set(q.key() for q in qs))
        router.update_params(params_b)
        pool.reset_counters(clear_log=True)
        after = run_closed_loop(router, qs, concurrency=8)
        serve_fn = _oracle(model, params_b)
        for r in pool.replicas().values():
            check_against_offline(r.engine.batch_log, serve_fn)
            assert r.stats()["params_version"] == 1
    fresh = ReplicaPool(model, params_b, n_replicas=2, cfg=cfg, mat_budget_rows=64,
                        device="cpu")
    with Router(fresh) as router2:
        ref = run_closed_loop(router2, qs, concurrency=8)
    for got, want in zip(after.results, ref.results):
        assert got["top_entities"] == want["top_entities"]
        assert got["scores"] == want["scores"]


def test_inflight_pre_swap_served_on_admitted_params_against_reference():
    """Requests admitted before ``update_params`` are served on the old
    params, those after it on the new: bitwise the port's oracle, and the
    JAX package's oracle on the same weights at the tolerance."""
    from repro.core import PooledExecutor as JExecutor
    from repro.launch.serve import serve_batch as j_serve
    from repro_torch.models import params_from_numpy
    from repro_torch.serving import ServingEngine

    from repro.models import ModelConfig as JCfg, make_model as j_make
    from repro_torch.models import ModelConfig as TCfg, make_model as t_make

    jkg, _ = graphs()
    jm = j_make("gqe", JCfg(dim=16))
    jp = jm.init_params(jax.random.PRNGKey(0), jkg.n_entities, jkg.n_relations)
    jp_b = jm.init_params(jax.random.PRNGKey(11), jkg.n_entities, jkg.n_relations)
    tm = t_make("gqe", TCfg(dim=16), device="cpu")
    tp = params_from_numpy(tm, {k: np.asarray(v) for k, v in jp.items()})
    tm_b_params = params_from_numpy(tm, {k: np.asarray(v) for k, v in jp_b.items()})
    jq, tq = queries(16, seed=17)
    eng = ServingEngine(tm, tp, started=False, device="cpu",
                        cfg=_cfg(pin_params_on_admit=True))
    try:
        pre = [eng.submit(q) for q in tq[:8]]
        eng.update_params(tm_b_params)
        post = [eng.submit(q) for q in tq[8:]]
        eng.start()
        got_pre = [f.result(timeout=60) for f in pre]
        got_post = [f.result(timeout=60) for f in post]
    finally:
        eng.close()
    assert eng.stats()["params_version"] == 1
    jex = JExecutor(jm, b_max=256)
    for got, tparams, jparams, jqs, tqs in ((got_pre, tp, jp, jq[:8], tq[:8]),
                                            (got_post, tm_b_params, jp_b, jq[8:], tq[8:])):
        want = _oracle(tm, tparams)(tqs)
        for g, w in zip(got, want):
            assert (g["top_entities"], g["scores"]) == (w["top_entities"], w["scores"])
        jwant, _ = j_serve(jm, jparams, jex, jqs, top_k=10)
        for g, w in zip(got, jwant):
            assert g["top_entities"] == w["top_entities"]
            np.testing.assert_allclose(g["scores"], w["scores"], rtol=FP32["rtol"],
                                       atol=FP32["atol"] + 1e-3)


def test_default_engine_has_no_params_version_and_pin_refuses_kg():
    from repro_torch.serving import ServingConfig, ServingEngine

    kg, model, params = _served()
    eng = ServingEngine(model, params, started=False, device="cpu")
    try:
        assert "params_version" not in eng.stats()
    finally:
        eng.close(drain=False)
    with pytest.raises(ValueError):
        ServingEngine(model, params, cfg=ServingConfig(pin_params_on_admit=True),
                      kg=kg, started=False, device="cpu")


def test_tenant_mix_open_loop_and_metric_labels():
    from repro_torch.obs.registry import get_registry
    from repro_torch.serving import (ReplicaPool, Router, TenantLoad, TenantSpec,
                                     make_workload, run_open_loop, run_tenant_mix)

    kg, model, params = _served()
    qs = make_workload(kg, 24, seed=19)
    pool = ReplicaPool(model, params, n_replicas=2, cfg=_cfg(max_wait_ms=2.0),
                       device="cpu")
    router = Router(pool, tenants=[TenantSpec("gold", "high"),
                                   TenantSpec("bronze", "low")])
    with router:
        reports = run_tenant_mix(router, [TenantLoad("gold", qs[:8], qps=0.0),
                                          TenantLoad("bronze", qs[8:16], qps=0.0)])
        rep = run_open_loop(router, qs[16:], qps=200.0)
        snap = get_registry().snapshot()
        st = router.stats()
    assert reports["gold"].completed == 8 and reports["gold"].failures == 0
    b = reports["bronze"]
    assert b.completed + b.shed == 8 and b.failures == 0
    assert rep.mode == "open" and len(rep.results) == 8 and rep.offered_qps > 0
    assert "[tenant gold]" in reports["gold"].describe()
    assert snap.get("serving_submitted{tenant=gold}", 0) >= 8
    assert any(k.startswith("serving_batches{replica=") for k in snap)
    assert st["routed"] == 16 + b.completed
    assert st["pool"]["replicas"] == 2


def test_pool_membership_add_and_remove():
    from repro_torch.serving import ReplicaPool, Router, make_workload, run_closed_loop

    kg, model, params = _served()
    pool = ReplicaPool(model, params, n_replicas=2, cfg=_cfg(max_wait_ms=2.0),
                       device="cpu")
    with Router(pool) as router:
        t0 = pool.membership_token
        rid = pool.add_replica()
        assert rid == 2 and len(pool) == 3 and pool.membership_token == t0 + 1
        qs = make_workload(kg, 16, seed=3)
        assert all(r is not None for r in run_closed_loop(router, qs, concurrency=8).results)
        pool.remove_replica(0)
        assert sorted(pool.replicas()) == [1, 2]
        assert all(r is not None for r in run_closed_loop(router, qs, concurrency=8).results)
        assert pool.stats()["failures"] == 0


def test_cli_replicas_and_tenants_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--model", "gqe", "--reduced", "--device", "cpu", "--dim", "8",
          "--requests", "48", "--replicas", "2", "--tenants", "gold:high,bronze:low",
          "--priority-mix", "gold=0.5,bronze=0.5", "--materialize", "64"])
    out = capsys.readouterr().out
    assert "warmup: 48 requests over 2 replicas" in out
    assert "replica 0:" in out and "replica 1:" in out and "router:" in out
