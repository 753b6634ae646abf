"""The port's kernel autotuner (``repro_torch.kernels.autotune``) on the CPU,
against the JAX package's (``repro.kernels.autotune``) and its scheduler and
compiler: the shape math, ``bucket_size(n, b_max, tile)``, and the schedules,
plans and their ``stats`` under one ``PoolTilePolicy`` exactly equal; the
pooled encode under a policy against the reference's and against the port's
own without one; an empty tuner changing nothing; and the reference's
behaviours of the tuner itself (persisted cache, corrupt files, the
environment variable, the policy bridge, the bit-identity gate, metrics)."""
import json
import os

import numpy as np
import pytest
import torch

from repro.core import compile_batch as j_compile
from repro.core.scheduler import bucket_size as j_bucket_size
from repro.kernels import autotune as jat
from repro_torch.core import compile_batch as t_compile
from repro_torch.core.scheduler import bucket_size as t_bucket_size
from repro_torch.kernels import autotune as at
from repro_torch.kernels import ops as kops
from test_torch_models import FAMILIES
from torch_parity import ENCODE, carried_models, queries

torch.set_num_threads(1)

BUCKET = (16, 2, 16, 32)   # a small intersect bucket: (rows, k, d, hd)


@pytest.fixture
def tuner(tmp_path):
    return at.KernelTuner(path=str(tmp_path / "tiles.json"), iters=1, warmup=0)


@pytest.fixture(autouse=True)
def _isolate_global_tuners():
    prev, jprev = at.set_tuner(None), jat.set_tuner(None)
    yield
    at.set_tuner(prev)
    jat.set_tuner(jprev)


def _tiles(op_type):
    """One tile table for both packages' ``PoolTilePolicy``: a quarter of
    the bucket for every operator class and cardinality, so that most pools
    pad to a multiple of a tile below their power of two."""
    return {(int(op), card, nb): max(1, nb // 4)
            for op in op_type for card in (0, 1, 2, 3) for nb in (1, 2, 4, 8, 16, 32, 64)}


def _policies():
    from repro.core.ops import OpType as JOp
    from repro_torch.core.ops import OpType as TOp

    return jat.PoolTilePolicy(_tiles(JOp)), at.PoolTilePolicy(_tiles(TOp))


# ------------------------------------------------------------- shape math
@pytest.mark.parametrize("fn,args", [
    ("pow2ceil", [(n,) for n in (0, 1, 2, 3, 8, 9, 511, 512, 513, 14951)]),
    ("ceil_to", [(n, m) for n in (1, 13, 16, 288, 511) for m in (1, 8, 64, 128)]),
    ("rows_bucket", [(n, f) for n in (0, 1, 5, 8, 9, 300, 4096, 14951) for f in (1, 8, 128)]),
    ("row_block", [(n, t, f) for n in (1, 3, 8, 13, 100, 288, 511)
                   for t in (1, 8, 32, 128, 256) for f in (1, 8)]),
    ("scoring_bucket", [(B, N, d) for B in (1, 16, 70) for N in (100, 4096, 14951)
                        for d in (8, 400)]),
    ("intersect_bucket", [(n, k, 800, 800) for n in (1, 8, 9, 288, 512) for k in (2, 3)]),
    ("gather_fuse_bucket", [(n, 400, 1024, 64) for n in (1, 48, 128, 4096, 14951)]),
])
def test_shape_math_equals_the_reference(fn, args):
    for a in args:
        assert getattr(at, fn)(*a) == getattr(jat, fn)(*a), (fn, a)


@pytest.mark.parametrize("tile", [1, 8, 64, 256])
def test_bucket_size_equals_the_reference(tile):
    """The reference test's grid (``tests/test_autotune.py``), and its
    properties: never more pad than pow2, covers the pool, launch-aligned."""
    for n in (1, 5, 17, 100, 288, 500, 512, 700):
        for b_max in (128, 512):
            got = t_bucket_size(n, b_max, tile)
            assert got == j_bucket_size(n, b_max, tile), (n, b_max)
            pow2 = t_bucket_size(n, b_max)
            assert min(n, b_max) <= got <= pow2
            if tile > 1 and n < b_max:
                assert got % min(tile, pow2) == 0
            assert t_bucket_size(n, b_max, 1) == pow2


def test_bucket_size_saves_pad_waste():
    assert t_bucket_size(288, 512) == 512
    assert t_bucket_size(288, 512, 64) == 320
    assert t_bucket_size(288, 512, 128) == 384


# ------------------------------------- schedules and plans under a policy
def _assert_plans_equal(jp, tp):
    assert jp.signature == tp.signature
    assert jp.meta == tp.meta
    for field in ("slot_arrays", "bind_arrays"):
        for a, b in zip(getattr(jp, field), getattr(tp, field), strict=True):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(jp.answer_slots, tp.answer_slots)
    np.testing.assert_array_equal(jp.order, tp.order)
    assert jp.n_slots_padded == tp.n_slots_padded
    for js, ts in zip(jp.sched.steps, tp.sched.steps, strict=True):
        assert (int(js.op), js.cardinality, js.padded_n) == (int(ts.op), ts.cardinality,
                                                            ts.padded_n)
        np.testing.assert_array_equal(js.node_ids, ts.node_ids)
        np.testing.assert_array_equal(js.in_slots, ts.in_slots)
        np.testing.assert_array_equal(js.out_slots, ts.out_slots)
    assert jp.sched.stats == tp.sched.stats


@pytest.mark.parametrize("b_max", [16, 512])
@pytest.mark.parametrize("cse", [True, False])
def test_plans_under_a_policy_equal_the_reference(cse, b_max):
    jpol, tpol = _policies()
    jq, tq = queries(40, seed=5)
    jp = j_compile(jq, model_name="betae", b_max=b_max, cse=cse, tile_policy=jpol)
    tp = t_compile(tq, model_name="betae", b_max=b_max, cse=cse, tile_policy=tpol)
    _assert_plans_equal(jp, tp)
    plain = t_compile(tq, model_name="betae", b_max=b_max, cse=cse)
    # The policy moved padding, and saved some.
    assert [s.padded_n for s in tp.sched.steps] != [s.padded_n for s in plain.sched.steps]
    assert tp.sched.stats["pad_waste"] < plain.sched.stats["pad_waste"]


@pytest.mark.parametrize("cse", [True, False])
def test_schedule_stats_equal_the_reference(cse):
    jq, tq = queries(24, seed=6)
    jp = j_compile(jq, model_name="gqe", b_max=64, cse=cse)
    tp = t_compile(tq, model_name="gqe", b_max=64, cse=cse)
    assert jp.sched.stats == tp.sched.stats
    assert set(tp.sched.stats) == {"steps", "nodes", "peak_slots", "slot_reuse_ratio",
                                   "mean_pool_fill", "pad_waste"}


@pytest.mark.parametrize("cse", [True, False])
def test_policy_key_is_in_both_cache_keys(cse):
    """The policy's key enters the schedule-cache key and the plan-cache
    key: one cache pair serving two policies never aliases their plans."""
    from repro_torch.core.compile_cache import CompileCache
    from repro_torch.core.compiler import PlanCache

    _, tpol = _policies()
    _, tq = queries(24, seed=3)
    sched, plans = CompileCache(16, name="schedule"), PlanCache(16)
    kw = dict(model_name="gqe", b_max=64, cse=cse, sched_cache=sched, plan_cache=plans)
    plain = t_compile(tq, **kw)
    tuned = t_compile(tq, tile_policy=tpol, **kw)
    assert plain.structure_key != tuned.structure_key
    assert plain.structure_key[-1] == () and tuned.structure_key[-1] == tpol.key()
    assert tuned is not plain and plain.meta != tuned.meta
    assert len(plans) == 2 and int(sched.misses) == 2
    assert t_compile(tq, tile_policy=tpol, **kw) is tuned


# --------------------------------------------------------- pooled encodes
@pytest.mark.parametrize("name", FAMILIES)
def test_encode_under_a_policy_matches_reference(name):
    """The port's pooled encode and the reference's (its Pallas kernels in
    interpret mode), both under the same policy."""
    from repro.core import PooledExecutor as JExecutor
    from repro_torch.core import PooledExecutor

    jpol, tpol = _policies()
    jm, jp, tm, tp = carried_models(name, use_pallas=True)
    jq, tq = queries(16, seed=2)
    want = np.asarray(JExecutor(jm, b_max=16, tile_policy=jpol).encode(jp, jq))
    got = PooledExecutor(tm, b_max=16, device="cpu", tile_policy=tpol).encode(tp, tq).numpy()
    np.testing.assert_allclose(got, want, **ENCODE)


@pytest.mark.parametrize("name", FAMILIES)
def test_encode_with_and_without_a_policy(name):
    """Padding moves no real row: bitwise for GQE and ComplEx, whose pooled
    operators are row-wise on the CPU; within the encode tolerance for the
    families whose operators go through matrix products, whose rows may sum
    in another order at another row count."""
    from repro_torch.core import PooledExecutor

    _, tpol = _policies()
    _, _, tm, tp = carried_models(name)
    _, tq = queries(24, seed=3)
    tuned = PooledExecutor(tm, b_max=16, device="cpu", tile_policy=tpol)
    plain = PooledExecutor(tm, b_max=16, device="cpu", tile_policy=None)
    got, want = tuned.encode(tp, tq), plain.encode(tp, tq)
    if name in ("gqe", "complex"):
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **ENCODE)
    # A closed signature universe: replaying the same queries builds nothing.
    tuned.reset_cache_counters()
    tuned.encode(tp, tq)
    assert all(int(c["misses"]) == 0 for c in tuned.cache_stats().values())


def test_an_empty_tuner_changes_nothing():
    """With no tuned entry: no policy, plans equal to ``tile_policy=None``'s
    (and the reference's), the same encode bits, and every wrapper's config
    the kernel's own choice (knob 0)."""
    from repro.core import PooledExecutor as JExecutor
    from repro_torch.core import PooledExecutor

    jm, jp, tm, tp = carried_models("betae")
    jq, tq = queries(24, seed=4)
    auto = PooledExecutor(tm, b_max=16, device="cpu")
    assert auto.tile_policy is None
    plain = PooledExecutor(tm, b_max=16, device="cpu", tile_policy=None)
    _assert_plans_equal(JExecutor(jm, b_max=16).prepare(jq), auto.prepare(tq))
    _assert_plans_equal(plain.prepare(tq), auto.prepare(tq))
    assert torch.equal(auto.encode(tp, tq), plain.encode(tp, tq))
    t = torch.zeros(1)
    assert at.tuned_config("scoring", (16, 14951, 400), t) == {"tile": 0}
    assert at.tuned_config("intersect", (8, 2, 800, 800), t) == {"rows": 0}
    assert at.tuned_config("gather_fuse", (128, 400, 1024, 64), t) == {"rows": 0}
    assert len(at.get_tuner()) == 0


# ------------------------------------------------------- knob validation
def test_wrappers_check_their_knob_on_the_cpu():
    """A knob the kernel does not take raises on CPU tensors too (the plain
    version takes none): no geometry falls back to another."""
    g = torch.Generator().manual_seed(0)
    q, e = torch.randn(4, 8, generator=g), torch.randn(33, 8, generator=g)
    ref = kops.scoring(q, e, 1.0)
    for tile in (0, 16, 4):
        assert torch.equal(kops.scoring(q, e, 1.0, tile=tile), ref)
    with pytest.raises(ValueError, match="tile"):
        kops.scoring(q, e, 1.0, tile=8)
    x, w1 = torch.randn(5, 3, 8, generator=g), torch.randn(8, 6, generator=g)
    mlp = (w1, torch.zeros(6), torch.randn(6, 1, generator=g), torch.zeros(1))
    ref = kops.intersect(x, *mlp)
    for rows in (0, 1, 2, 21, 64):
        assert torch.equal(kops.intersect(x, *mlp, rows=rows), ref)
    for rows in (-1, 2.0, True):
        with pytest.raises(ValueError, match="rows"):
            kops.intersect(x, *mlp, rows=rows)
    big = torch.zeros(65536, 2, 1)
    one = (torch.zeros(1, 1), torch.zeros(1), torch.zeros(1, 1), torch.zeros(1))
    with pytest.raises(ValueError, match="row groups"):
        kops.intersect(big, *one, rows=1)
    assert kops.intersect(big, *one, rows=2).shape == (65536, 1)
    ids = torch.tensor([3, 1, 3])
    fuse = (torch.randn(4, 8, generator=g), torch.randn(4, 6, generator=g),
            torch.randn(6, 2, generator=g), torch.zeros(2), torch.randn(10, 8, generator=g),
            torch.zeros(8))
    ref = kops.gather_fuse(ids, *fuse)
    for rows in (0, 64, 128):
        assert torch.equal(kops.gather_fuse(ids, *fuse, rows=rows), ref)
    with pytest.raises(ValueError, match="rows"):
        kops.gather_fuse(ids, *fuse, rows=32)


def test_candidates_are_the_ports_knobs():
    assert at.scoring_candidates((16, 16384, 400), 16) == [{"tile": 0}, {"tile": 4}]
    assert at.scoring_candidates((16, 4096, 400)) == [{"tile": 0}, {"tile": 16}, {"tile": 4}]
    assert at.gather_fuse_candidates((128, 400, 1024, 64), 64) == [{"rows": 0}, {"rows": 128}]
    # Powers of two below group_rows(k) = 64 // k and below the pool's rows.
    assert at.intersect_candidates((512, 2, 800, 800)) == [
        {"rows": r} for r in (0, 1, 2, 4, 8, 16)]
    assert at.intersect_candidates((512, 3, 800, 800)) == [
        {"rows": r} for r in (0, 1, 2, 4, 8, 16)]
    assert at.intersect_candidates((8, 2, 800, 800)) == [{"rows": r} for r in (0, 1, 2, 4)]


# ------------------------------------------------- the tuner's behaviours
def test_tune_serves_from_the_cache_after_one_sweep(tuner):
    cfg = tuner.tune("intersect", BUCKET, device="cpu")
    assert cfg in at.intersect_candidates(BUCKET)
    assert tuner.tune("intersect", BUCKET, device="cpu") == cfg
    assert int(tuner.sweeps) == 1
    (e,) = tuner.entries().values()
    assert e["device"] == "cpu" and e["us"] <= e["default_us"] and e["n_rejected"] == 0
    assert tuner.config_for("intersect", BUCKET, device="cpu") == cfg


def test_tune_needs_a_gpu_unless_told_cpu(tuner, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tuner.tune("intersect", BUCKET)


def test_cache_roundtrip(tuner):
    cfg = tuner.tune("intersect", BUCKET, device="cpu")
    assert os.path.exists(tuner.path)
    fresh = at.KernelTuner(path=tuner.path, iters=1, warmup=0)
    assert len(fresh) == 1
    assert fresh.tune("intersect", BUCKET, device="cpu") == cfg
    assert int(fresh.sweeps) == 0  # served from disk, no re-sweep


@pytest.mark.parametrize("payload", [
    "not json at all {{{",
    '{"version": 99, "entries": {}}',
    '{"version": 1}',
    '{"version": 1, "entries": {"k": {"op": "intersect"}}}',
    '{"version": 1, "entries": {"k": {"op": "nope", "config": {"rows": 8}}}}',
    '{"version": 1, "entries": {"k": {"op": "intersect", "config": {"rows": -4}}}}',
    '{"version": 1, "entries": {"k": {"op": "intersect", "config": {"wrong_key": 8}}}}',
    '{"version": 1, "entries": {"k": {"op": "scoring", "config": {"tile": 8}}}}',
    '{"version": 1, "entries": {"k": {"op": "gather_fuse", "config": {"rows": 32}}}}',
    '{"version": 1, "entries": {"a": {"op": "intersect", "config": {"rows": 4}}, '
    '"b": {"op": "intersect", "config": {"rows": true}}}}',
])
def test_corrupt_cache_rejected_not_crashed(tmp_path, payload):
    p = tmp_path / "tiles.json"
    p.write_text(payload)
    t = at.KernelTuner(path=str(p), iters=1, warmup=0)
    assert len(t) == 0                 # nothing partial leaked in
    assert t.load_error is not None    # and the rejection is recorded
    assert int(t.load_rejects) == 1
    cfg = t.tune("intersect", BUCKET, device="cpu")   # retunes instead
    assert set(cfg) == {"rows"}
    fresh = at.KernelTuner(path=str(p))  # the rewrite repaired the file
    assert fresh.load_error is None and len(fresh) == 1


def test_partial_write_never_visible(tuner):
    tuner.tune("intersect", BUCKET, device="cpu")
    with open(tuner.path) as f:
        payload = json.load(f)
    assert payload["version"] == at.CACHE_VERSION
    assert not os.path.exists(tuner.path + ".tmp")


def test_env_var_names_the_default_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(at.ENV_CACHE, str(tmp_path / "env_tiles.json"))
    monkeypatch.delenv(jat.ENV_CACHE, raising=False)
    at.set_tuner(None)
    assert at.get_tuner().path == str(tmp_path / "env_tiles.json")
    # The port's own variable: the reference's tuner does not read it.
    jat.set_tuner(None)
    assert jat.get_tuner().path is None and at.ENV_CACHE != jat.ENV_CACHE


def _tuned_policy_for(model, tuner, monkeypatch, b_max=64):
    """A policy from a CPU sweep in which each candidate times faster than
    the one before (the clock is monkeypatched: CPU timings decide nothing
    here), so every entry holds the last candidate as its tile."""
    monkeypatch.setattr(at, "_time_us",
                        lambda fns, *a: [(fn(), 100.0 / (1 + i))[1] for i, fn in enumerate(fns)])
    n = at.tune_for_model(model, tuner, b_max=b_max, batch=16, device="cpu")
    assert n > 0
    policy = at.pool_tile_policy(model, tuner, b_max=b_max)
    assert policy
    return policy


def test_policy_from_a_sweep_is_bitwise_and_closed(tuner, monkeypatch):
    from repro_torch.core import PooledExecutor

    _, _, tm, tp = carried_models("gqe", dim=8)
    policy = _tuned_policy_for(tm, tuner, monkeypatch)
    assert policy.tile(2, 2, 64) > 1 and policy.tile(1, 1, 64) == 1
    _, tq = queries(24, seed=3)
    tuned = PooledExecutor(tm, b_max=64, device="cpu", tile_policy=policy)
    plain = PooledExecutor(tm, b_max=64, device="cpu", tile_policy=None)
    assert torch.equal(tuned.encode(tp, tq), plain.encode(tp, tq))
    tuned.reset_cache_counters()
    tuned.encode(tp, tq)
    assert all(int(c["misses"]) == 0 for c in tuned.cache_stats().values())


def test_policy_key_separates_cache_entries(tuner, monkeypatch):
    _, _, tm, _ = carried_models("gqe", dim=8)
    policy = _tuned_policy_for(tm, tuner, monkeypatch)
    _, tq = queries(24, seed=3)
    plain = t_compile(tq, model_name=tm.name, b_max=64)
    tuned = t_compile(tq, model_name=tm.name, b_max=64, tile_policy=policy)
    assert plain.structure_key != tuned.structure_key


def test_untuned_tuner_means_no_policy():
    _, _, tm, _ = carried_models("gqe", dim=8)
    assert at.pool_tile_policy(tm, at.KernelTuner()) is None


def test_policy_takes_only_its_devices_non_default_entries(tuner):
    """An entry tuned on another card, or whose config is the kernel's own
    choice, gives no tile."""
    _, _, tm, _ = carried_models("betae")   # state_dim 32
    sd, hd = tm.state_dim, 2 * tm.cfg.dim
    base = {"op": "intersect", "dtype": "float32", "us": 1.0, "default_us": 2.0}
    tuner._entries.update({
        "a": {**base, "bucket": [16, 2, sd, hd], "device": "cpu", "config": {"rows": 4}},
        "b": {**base, "bucket": [32, 2, sd, hd], "device": "cpu", "config": {"rows": 0}},
        "c": {**base, "bucket": [64, 2, sd, hd], "device": "Some Other Card",
              "config": {"rows": 8}},
        "d": {**base, "bucket": [16, 3, sd + 1, hd], "device": "cpu", "config": {"rows": 2}},
    })
    policy = at.pool_tile_policy(tm, tuner)
    assert policy.key() == (((2, 2, 16), 4), ((3, 2, 16), 4))


def test_auto_snapshots_the_process_tuner(tuner, monkeypatch):
    from repro_torch.core import PooledExecutor, QueryLevelExecutor

    _, _, tm, _ = carried_models("gqe", dim=8)
    _tuned_policy_for(tm, tuner, monkeypatch)
    at.set_tuner(tuner)
    ex = PooledExecutor(tm, b_max=64, device="cpu")   # tile_policy="auto"
    assert ex.tile_policy
    assert QueryLevelExecutor(tm, b_max=64, device="cpu")._inner.tile_policy
    at.set_tuner(None)
    assert PooledExecutor(tm, b_max=64, device="cpu").tile_policy is None
    assert ex.tile_policy   # a snapshot: fixed for the executor's lifetime


def test_sweep_rejects_nonbitwise_candidates(tuner, monkeypatch):
    """A candidate whose output differs by one bit is rejected before it is
    timed, and never cached."""
    real = at.make_runner

    def poisoned(op, bucket, dtype, device):
        run, args = real(op, bucket, dtype, device)

        def bad_run(cfg, *a):
            out = run(cfg, *a)
            return torch.nextafter(out, out + 1) if cfg.get("rows") == 2 else out

        return bad_run, args

    monkeypatch.setattr(at, "make_runner", poisoned)
    cfg = tuner.tune("intersect", BUCKET, device="cpu")
    assert cfg["rows"] != 2
    assert int(tuner.verify_rejects) == 1
    (e,) = tuner.entries().values()
    assert e["n_rejected"] == 1 and e["n_candidates"] == len(at.intersect_candidates(BUCKET))


def test_a_challenger_must_beat_the_default_by_the_margin(tuner, monkeypatch):
    times = [100.0, 95.0, 91.0, 50.0, 89.0]   # default, then rows 1, 2, 4, 8
    monkeypatch.setattr(at, "_time_us",
                        lambda fns, *a: [(fn(), t)[1] for fn, t in zip(fns, times)])
    assert tuner.tune("intersect", BUCKET, device="cpu") == {"rows": 4}
    (e,) = tuner.entries().values()
    assert (e["us"], e["default_us"]) == (50.0, 100.0)
    times = [100.0, 95.0, 91.0, 92.0, 93.0]
    assert tuner.tune("intersect", BUCKET, device="cpu", force=True) == {"rows": 0}


def test_sweep_times_its_candidates_in_interleaved_rounds(monkeypatch):
    """Each round times every candidate once, rotated; each candidate's time
    is its minimum over the rounds."""
    order, clock = [], iter(range(1000))
    monkeypatch.setattr(at.time, "perf_counter", lambda: float(next(clock)))
    fns = [lambda i=i: order.append(i) for i in range(3)]
    times = at._time_us(fns, iters=3, warmup=1, flush=None)
    assert order == [0, 1, 2] + [0, 1, 2] + [1, 2, 0] + [2, 0, 1]
    assert times == [1e6, 1e6, 1e6]


def test_autotune_metrics_published(tuner):
    from repro_torch.obs import get_registry

    tuner.tune("intersect", BUCKET, device="cpu")
    tuner.config_for("intersect", BUCKET, device="cpu")
    tuner.config_for("intersect", (999, 2, 16, 32), device="cpu")  # untuned: default
    snap = get_registry().snapshot()
    assert snap["autotune_sweeps"] >= 1
    assert snap["autotune_lookup_hits"] >= 1
    assert snap["autotune_lookup_misses"] >= 1
    assert snap["autotune_entries"] == 1
    assert tuner.stats()["saves"] == 1 and tuner.stats()["entries"] == 1


def test_tune_for_model_covers_the_reference_buckets(tuner, monkeypatch):
    """The same buckets as the reference's ``tune_for_model``: scoring at
    (batch × entities × dim), intersect on the pool ladder per k at the
    model's state_dim and MLP width, gather_fuse at the embed set."""
    from repro.models import ModelConfig as JCfg, make_model as j_make
    from repro_torch.models import ModelConfig, make_model

    jt, want = jat.KernelTuner(), set()
    # The reference's sweeps are not run: its tuner records what it is asked.
    monkeypatch.setattr(jt, "tune", lambda op, bucket, **kw: want.add((op, tuple(bucket))))
    for name in ("betae", "gqe"):
        cfg = dict(dim=8, semantic_dim=16 if name == "gqe" else 0)
        tm = make_model(name, ModelConfig(**cfg), device="cpu")
        assert at.tune_for_model(tm, tuner, b_max=64, batch=16, device="cpu") > 0
        jat.tune_for_model(j_make(name, JCfg(**cfg)), jt, b_max=64, batch=16, interpret=True)
    got = {(e["op"], tuple(e["bucket"])) for e in tuner.entries().values()}
    assert got == want and len(got) == len(tuner)
    assert at.tune_for_model(tm, tuner, b_max=64, batch=16, device="cpu") == 0
