"""The port's pipelined trainer (a scheduler thread building step k+1 while
the main thread dispatches step k) on the CPU: bitwise equal to the sync
trainer on the same batches, its losses against the JAX package's pipelined
trainer, its work items exactly the JAX package's ``prepare_work_item``'s,
checkpoints inside the in-flight window, the prefetchers' errors and
shutdown, and the semantic hot set staged in the background. Small widths
(dim 8–16, batch 16–24, 4–8 negatives); every ``next()`` has a timeout."""
import itertools
import time

import jax  # noqa: F401  (on the CPU, before the JAX package's modules)
import numpy as np
import pytest
import torch

from torch_parity import graphs

torch.set_num_threads(1)

N_ENT = 200                 # the shared graph's entities (torch_parity.KG_SHAPE)
PATTERNS = ("1p", "2p", "2i", "3i", "ip", "pi", "2u", "2in")


def _trainer(pipeline: bool, model="gqe", kg=None, mcfg=None, sem=None, **kw):
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.training import AdamConfig, NGDBTrainer, TrainConfig

    kg = graphs()[1] if kg is None else kg
    cfg = TrainConfig(**{**dict(batch_size=16, n_negatives=4, b_max=32, prefetch=2,
                                pipeline=pipeline, adam=AdamConfig(lr=1e-3), seed=0), **kw})
    return NGDBTrainer(make_model(model, mcfg or ModelConfig(dim=8), device="cpu"), kg, cfg,
                       **(sem or {}))


@pytest.fixture(scope="module")
def replay_batches():
    """A fixed mixed-pattern workload from a DEDICATED sampler, so the
    trainers' own samplers draw identical negative streams in replay."""
    from repro_torch.sampling import OnlineSampler

    src = OnlineSampler(graphs()[1], seed=123)
    return [src.sample_batch(16) for _ in range(5)]


@pytest.fixture(scope="module")
def table():
    """H_sem [200, 32]: unit rows from a seeded numpy generator."""
    t = np.random.default_rng(21).normal(size=(N_ENT, 32))
    return (t / np.linalg.norm(t, axis=1, keepdims=True)).astype(np.float32)


def _assert_same_training(a, b):
    assert [r["loss"] for r in a.history] == [r["loss"] for r in b.history]
    assert a.params.keys() == b.params.keys()
    for k in a.params:
        torch.testing.assert_close(a.params[k], b.params[k], rtol=0, atol=0)
        if k in a.opt_state["m"]:
            torch.testing.assert_close(a.opt_state["v"][k], b.opt_state["v"][k],
                                       rtol=0, atol=0)


# ------------------------------------------------- pipelined against sync
@pytest.mark.parametrize("model", ["gqe", "betae"])
def test_pipelined_matches_sync_bitwise(model, replay_batches):
    """The same workload through both modes: the same losses and parameters,
    bit for bit (atol 0)."""
    sync, pipe = _trainer(False, model), _trainer(True, model)
    sync.train(len(replay_batches), log_every=0, batches=replay_batches)
    pipe.train(len(replay_batches), log_every=0, batches=replay_batches)
    _assert_same_training(sync, pipe)
    assert len(pipe.step_phases) == len(replay_batches)
    for phases in pipe.step_phases:
        assert {"negatives_s", "schedule_s", "transfer_s", "sample_s", "pipeline_wait_s",
                "dispatch_s", "retire_s"} <= set(phases)


def test_pipelined_respects_step_count_and_history(replay_batches):
    tr = _trainer(True)
    tr.train(7, log_every=0, batches=replay_batches)
    assert tr.step == 7 and len(tr.history) == 7
    assert [r["step"] for r in tr.history] == list(range(1, 8))
    assert all(np.isfinite(r["loss"]) for r in tr.history)
    assert int(tr._steps_done) == 7 and int(tr._inflight_gauge) == 0
    for phase in ("pipeline_wait", "dispatch", "retire"):
        assert float(tr._phase_s[phase]) > 0, phase


def test_pipelined_online_sampling_smoke():
    """No batch list: sampling workers feed the scheduler thread."""
    tr = _trainer(True)
    tr.train(3, log_every=0)
    assert tr.step == 3 and all(np.isfinite(r["loss"]) for r in tr.history)


def test_pipelined_error_surfaces_from_train():
    def boom():
        raise ValueError("no batches for you")

    tr = _trainer(True)
    with pytest.raises(RuntimeError, match="prefetcher failed") as info:
        tr.train(2, log_every=0, batches=boom)
    assert isinstance(info.value.__cause__, ValueError)
    assert tr.step == 0


def test_query_level_pipeline_falls_back_to_sync(replay_batches, monkeypatch):
    """``pipeline=True`` with the query-level executor trains sync, as the
    reference does: no scheduler thread, the sync run's losses."""
    import repro_torch.training.loop as loop

    def no_prefetcher(*a, **k):
        raise AssertionError("query_level must not start a scheduler thread")

    monkeypatch.setattr(loop, "PreparedBatchPrefetcher", no_prefetcher)
    pipe = _trainer(True, executor="query_level")
    sync = _trainer(False, executor="query_level")
    pipe.train(3, log_every=0, batches=replay_batches)
    sync.train(3, log_every=0, batches=replay_batches)
    _assert_same_training(sync, pipe)
    assert pipe.step_phases == []


def test_adaptive_pipelined_training_runs():
    """Adaptive sampling in the scheduler thread, with a stale π."""
    tr = _trainer(True, adaptive=True, max_inflight=2)
    start = dict(tr.adaptive.difficulty)
    tr.train(4, log_every=0)
    assert tr.step == 4 and all(np.isfinite(r["loss"]) for r in tr.history)
    assert tr.adaptive.difficulty != start


def test_sync_train_with_prefetch_uses_the_batch_prefetcher(monkeypatch):
    """Sync ``train`` with ``prefetch > 0``, no batches and no adaptive
    sampling takes its batches from a ``BatchPrefetcher`` and closes it:
    every thread it started has ended when ``train`` returns."""
    import repro_torch.training.loop as loop

    made = []

    class Counting(loop.BatchPrefetcher):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.taken = 0
            made.append(self)

        def next(self, timeout=120.0):
            self.taken += 1
            return super().next(timeout=timeout)

    monkeypatch.setattr(loop, "BatchPrefetcher", Counting)
    tr = _trainer(False, prefetch=2)
    tr.train(3, log_every=0)
    assert tr.step == 3 and len(made) == 1 and made[0].taken == 3
    assert not any(t.is_alive() for t in made[0].threads())
    _trainer(False, prefetch=0).train(1, log_every=0)
    _trainer(False, prefetch=2, adaptive=True).train(1, log_every=0)
    assert len(made) == 1   # inline sampling without prefetch or with adaptive


# ---------------------------------------------------------- checkpoints
def test_pipelined_checkpoint_roundtrip(replay_batches, tmp_path):
    """A checkpoint boundary inside the in-flight window holds that step's
    own state: the step-3 checkpoint equals a sync run's after 3 steps, and
    resume restores the final state."""
    import shutil

    from repro_torch.training.checkpoint import load_checkpoint

    tr = _trainer(True, checkpoint_dir=str(tmp_path / "run"), checkpoint_every=3)
    tr.train(5, log_every=0, batches=replay_batches)
    sync = _trainer(False)
    sync.train(3, log_every=0, batches=replay_batches)
    # load_checkpoint takes the newest in a directory: the step-3 one alone.
    shutil.copytree(tmp_path / "run" / "ckpt_0000000003", tmp_path / "three" / "ckpt_0000000003")
    step, tree, meta = load_checkpoint(str(tmp_path / "three"),
                                       template={"params": sync.params, "opt": sync.opt_state})
    assert step == 3 and meta == {"loss": sync.history[-1]["loss"]}
    for k, v in sync.params.items():
        torch.testing.assert_close(tree["params"][k], v, rtol=0, atol=0)
        torch.testing.assert_close(tree["opt"]["m"][k], sync.opt_state["m"][k], rtol=0, atol=0)
    assert int(tree["opt"]["step"]) == 3
    tr2 = _trainer(True, checkpoint_dir=str(tmp_path / "run"), checkpoint_every=3)
    assert tr2.resume() and tr2.step == 5
    for k in tr.params:
        torch.testing.assert_close(tr2.params[k], tr.params[k], rtol=0, atol=0)


# ------------------------------------------------------------ work items
def test_prefetcher_items_match_reference_prepare_work_item(replay_batches):
    """The port's work item and the JAX package's ``prepare_work_item`` on
    the same batch and sampler seed: the negatives, patterns, order, slot
    and bind arrays and the answer slots are exactly equal."""
    from repro.core import PooledExecutor as JExecutor
    from repro.data.pipeline import prepare_work_item as j_prepare
    from repro.models import ModelConfig as JCfg, make_model as j_make
    from repro.sampling import OnlineSampler as JSampler
    from repro_torch.core import PooledExecutor
    from repro_torch.data.pipeline import PreparedBatchPrefetcher
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.obs.registry import get_registry
    from repro_torch.sampling import OnlineSampler

    jkg, tkg = graphs()
    jsrc = JSampler(jkg, patterns=PATTERNS, seed=31)
    tsrc = OnlineSampler(tkg, patterns=PATTERNS, seed=31)
    jb = [jsrc.sample_batch(24) for _ in range(3)]
    tb = [tsrc.sample_batch(24) for _ in range(3)]
    jm, tm = j_make("betae", JCfg(dim=8)), make_model("betae", ModelConfig(dim=8), device="cpu")
    jex, jsam = JExecutor(jm, b_max=16), JSampler(jkg, patterns=PATTERNS, seed=5)
    it = itertools.cycle(tb)
    pf = PreparedBatchPrefetcher(OnlineSampler(tkg, patterns=PATTERNS, seed=5),
                                 PooledExecutor(tm, b_max=16, device="cpu"), 24, 6,
                                 depth=2, batch_fn=lambda: next(it))
    try:
        for b in jb:
            want, got = j_prepare(jsam, jex, b, 6), pf.next(timeout=30.0)
            np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
            np.testing.assert_array_equal(got.neg.numpy(), np.asarray(want.neg))
            assert got.patterns == want.patterns and got.n_queries == want.n_queries == 24
            np.testing.assert_array_equal(got.prepared.order, want.prepared.order)
            np.testing.assert_array_equal(got.ans.numpy(), np.asarray(want.ans))
            assert len(got.steps) == len(want.steps) == len(want.prepared.meta)
            for mine, theirs in ((got.prepared.slot_arrays, want.prepared.slot_arrays),
                                 (got.prepared.bind_arrays, want.prepared.bind_arrays),
                                 (got.steps, want.steps)):
                assert len(mine) == len(theirs)
                for a, b in zip(mine, theirs):
                    assert a.keys() == b.keys()
                    for k in a:
                        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
            assert {"negatives_s", "schedule_s", "transfer_s", "sample_s"} <= set(got.phases)
            assert got.event is None   # nothing to wait for on the CPU
        snap = get_registry().snapshot()
        assert "pipeline_prepared_q_depth" in snap
        for phase in ("sample", "negatives", "schedule", "transfer"):
            assert snap[f"pipeline_phase_seconds{{phase={phase}}}"] > 0, phase
    finally:
        pf.close()


def test_dev_static_keyed_by_structure_not_signature():
    """5 vs 6 queries of one pattern can share a SIGNATURE (same bucketed
    shapes) while having different slot/answer arrays — the device cache must
    key on the structure, not the signature."""
    from repro_torch.core import CompileCache
    from repro_torch.data.pipeline import prepare_work_item
    from repro_torch.sampling import OnlineSampler

    tr = _trainer(False)
    src = OnlineSampler(graphs()[1], seed=5, patterns=("1p",))
    batches = [src.sample_batch(n) for n in (5, 6, 7, 8) for _ in range(4)]
    plans = [tr.executor.prepare([b.query for b in x]) for x in batches]
    # The collision trap: two batches of one signature and two structures.
    i, j = next((i, j) for i, j in itertools.combinations(range(len(plans)), 2)
                if plans[i].signature == plans[j].signature
                and plans[i].structure_key != plans[j].structure_key
                and len(batches[i]) != len(batches[j]))
    cache = CompileCache(8, name="t")
    a = prepare_work_item(tr.sampler, tr.executor, batches[i], 4, cache)
    b = prepare_work_item(tr.sampler, tr.executor, batches[j], 4, cache)
    assert len(cache) == 2
    assert int(a.ans.shape[0]) == len(batches[i]) and int(b.ans.shape[0]) == len(batches[j])
    again = prepare_work_item(tr.sampler, tr.executor, batches[i], 4, cache)
    assert again.ans is a.ans and int(cache.hits) == 1


def test_prepare_work_item_under_a_one_rank_mesh(replay_batches, tmp_path):
    """Under a one-rank mesh the work item is the single-device one (the
    same negatives, plan and patterns) plus its rows (all of them) and the
    global batch's canonical order, which the plan's order is."""
    from repro_torch.data.pipeline import prepare_work_item
    from repro_torch.distributed import make_execution_context
    from torch_parity import one_rank_group

    batch = replay_batches[0]
    single = prepare_work_item(_trainer(False).sampler, _trainer(False).executor, batch, 4)
    with one_rank_group(tmp_path):
        ctx = make_execution_context("data=1", profile="fsdp", device="cpu")
        tr = _trainer(False)
        item = prepare_work_item(tr.sampler, tr.executor, batch, 4, ctx=ctx)
    assert item.n_queries == len(batch) and item.patterns == single.patterns
    np.testing.assert_array_equal(item.rows, np.arange(len(batch)))
    np.testing.assert_array_equal(item.global_order, item.prepared.order)
    assert torch.equal(item.pos, single.pos) and torch.equal(item.neg, single.neg)


def test_prefetcher_propagates_worker_error():
    from repro_torch.data.pipeline import PreparedBatchPrefetcher

    def boom():
        raise ValueError("no batches for you")

    tr = _trainer(False)
    pf = PreparedBatchPrefetcher(tr.sampler, tr.executor, 16, 4, batch_fn=boom)
    with pytest.raises(RuntimeError, match="prefetcher failed"):
        pf.next(timeout=10.0)
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_close_is_prompt(replay_batches):
    from repro_torch.data.pipeline import PreparedBatchPrefetcher

    tr = _trainer(False)
    it = itertools.cycle(replay_batches)
    pf = PreparedBatchPrefetcher(tr.sampler, tr.executor, 16, 4, depth=2,
                                 batch_fn=lambda: next(it))
    pf.next(timeout=30.0)
    t0 = time.monotonic()
    pf.close()
    assert time.monotonic() - t0 < 5.0
    assert not pf._thread.is_alive()


def test_prefetcher_over_sampling_workers_closes_its_thread():
    """Fed by its own sampling workers, the scheduler thread waits for a
    batch in short slices: ``close()`` ends it and every worker in 5 s."""
    from repro_torch.data.pipeline import PreparedBatchPrefetcher

    tr = _trainer(False)
    pf = PreparedBatchPrefetcher(tr.sampler, tr.executor, 16, 4, depth=1, workers=1)
    pf.next(timeout=30.0)
    t0 = time.monotonic()
    pf.close()
    assert time.monotonic() - t0 < 5.0
    assert not pf._thread.is_alive()
    assert not any(t.is_alive() for t in pf._batches.threads())


def test_batch_prefetcher_close_joins_its_threads():
    from repro_torch.data.pipeline import BatchPrefetcher

    tr = _trainer(False)
    bp = BatchPrefetcher(tr.sampler, 16, depth=2, workers=2)
    assert len(bp.next(timeout=30.0)) == 16
    t0 = time.monotonic()
    bp.close()
    assert time.monotonic() - t0 < 5.0
    assert not any(t.is_alive() for t in bp.threads())


# -------------------------------------------- against the JAX package
@pytest.mark.parametrize("name", ["gqe", "betae"])
def test_pipelined_trainer_losses_match_reference(name):
    """The port's pipelined trainer against the JAX package's, from carried
    parameters on the same fixed batches: the first loss within rtol 1e-4,
    every one within 1e-3 (the sync trainers' parity tolerance)."""
    from repro.models import ModelConfig as JCfg, make_model as j_make
    from repro.sampling import OnlineSampler as JSampler
    from repro.training import AdamConfig as JAdam, NGDBTrainer as JTrainer, TrainConfig as JTC
    from repro_torch.models import ModelConfig as TCfg, make_model as t_make
    from repro_torch.sampling import OnlineSampler as TSampler
    from repro_torch.training import AdamConfig as TAdam, NGDBTrainer as TTrainer, TrainConfig as TTC

    jkg, tkg = graphs()
    common = dict(batch_size=24, n_negatives=8, b_max=16, pipeline=True, prefetch=2,
                  patterns=PATTERNS)
    jt = JTrainer(j_make(name, JCfg(dim=16)), jkg, JTC(adam=JAdam(lr=3e-3), **common))
    tt = TTrainer(t_make(name, TCfg(dim=16), device="cpu"), tkg,
                  TTC(adam=TAdam(lr=3e-3), **common))
    tt.load_params({k: np.asarray(v) for k, v in jt.params.items()})
    jb = [JSampler(jkg, patterns=PATTERNS, seed=10 + i).sample_batch(24) for i in range(2)]
    tb = [TSampler(tkg, patterns=PATTERNS, seed=10 + i).sample_batch(24) for i in range(2)]
    jl = np.array([r["loss"] for r in jt.train(8, log_every=0, batches=jb)])
    tl = np.array([r["loss"] for r in tt.train(8, log_every=0, batches=tb)])
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-4)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


# ------------------------------------------------ the semantic hot set
def _semantic_trainer(pipeline, table, budget=184):
    from repro_torch.models import ModelConfig
    from repro_torch.semantic import SemanticCache

    cache = SemanticCache(table, budget_rows=budget, device="cpu")
    tr = _trainer(pipeline, mcfg=ModelConfig(dim=16, semantic_dim=32, semantic_proj_dim=8),
                  sem={"semantic_cache": cache}, batch_size=24, n_negatives=8, b_max=16,
                  patterns=PATTERNS)
    return tr, cache


@pytest.fixture(scope="module")
def sem_batches():
    from repro_torch.sampling import OnlineSampler

    src = OnlineSampler(graphs()[1], patterns=PATTERNS, seed=77)
    return [src.sample_batch(24) for _ in range(4)]


def test_semantic_hot_set_pipelined_matches_sync(table, sem_batches):
    """GQE+H_sem behind a 184-row hot set (below the graph's 200 rows, so
    steps evict): pipelined losses and parameters bitwise the sync run's,
    every stage planned in the background."""
    sync, scache = _semantic_trainer(False, table)
    pipe, pcache = _semantic_trainer(True, table)
    sync.train(6, log_every=0, batches=sem_batches)
    pipe.train(6, log_every=0, batches=sem_batches)
    _assert_same_training(sync, pipe)
    st = pcache.stats()
    assert st["stages"] > 0 and st["evictions"] > 0
    assert st["stages_background"] == st["stages"] and st["sync_stages"] == 0
    assert st["prefetch_overlap_frac"] == 1.0
    assert scache.stats()["stages_background"] == 0
    assert scache.stats()["prefetch_overlap_frac"] == 0.0
    assert all("sem_prefetch_s" in p for p in pipe.step_phases)


def test_reconcile_after_close_restages_from_the_store(table, sem_batches):
    """A prefetcher closed with stages planned and never applied leaves the
    cache's metadata ahead of its tensors: ``reconcile()`` drops all
    residency, and every slot the next step stages then holds its owner's
    H_sem row."""
    from repro_torch.data.pipeline import PreparedBatchPrefetcher

    tr, cache = _semantic_trainer(False, table)
    it = itertools.cycle(sem_batches)
    pf = PreparedBatchPrefetcher(tr.sampler, tr.executor, 24, 8, depth=2,
                                 batch_fn=lambda: next(it), sem_cache=cache)
    item = pf.next(timeout=30.0)
    cache.apply_to(tr.params, item.sem_stage)
    deadline = time.monotonic() + 30.0
    while cache._planned_seq < 2 and time.monotonic() < deadline:
        time.sleep(0.01)   # the thread runs ahead: a second stage is planned
    pf.close()
    assert cache._planned_seq > cache._applied_seq == 1
    cache.reconcile()
    assert cache.resident_rows == 0
    tr.train_step(sem_batches[3])
    ids = cache.resident_ids()
    assert len(ids) > 0
    slots = tr.params["sem_slot"][torch.from_numpy(ids)].long()
    np.testing.assert_array_equal(tr.params["sem_cache"][slots].numpy(), table[ids])
    cache.reconcile()   # every planned stage applied: residency stays
    assert cache.resident_rows == len(ids)


def test_pipelined_run_reconciles_the_cache(table, sem_batches):
    """A pipelined run ends with its prefetcher's unapplied stages dropped,
    so the next step restages what it needs: every slot it staged holds its
    owner's H_sem row."""
    tr, cache = _semantic_trainer(True, table)
    tr.train(3, log_every=0, batches=sem_batches)
    assert cache._planned_seq == cache._applied_seq
    tr.train_step(sem_batches[3])
    ids = cache.resident_ids()
    assert len(ids) > 0
    slots = tr.params["sem_slot"][torch.from_numpy(ids)].long()
    np.testing.assert_array_equal(tr.params["sem_cache"][slots].numpy(), table[ids])
