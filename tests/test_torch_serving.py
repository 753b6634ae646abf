"""The port's serving slice against the JAX package: pooled encode, the
offline ``serve_batch``, the engine's bitwise replay, and the device rules of
every entry point."""
import numpy as np
import pytest
import torch

from torch_parity import (BETAE_DISTANCE, ENCODE, FAMILIES, FP32,
                          carried_models, queries)

torch.set_num_threads(1)


def _port_executor(tm, **kw):
    from repro_torch.core import PooledExecutor

    return PooledExecutor(tm, b_max=16, device="cpu", **kw)


@pytest.mark.parametrize("cse", [True, False])
@pytest.mark.parametrize("name", FAMILIES)
def test_encode_matches_reference_with_kernels(name, cse):
    from repro.core import PooledExecutor as JExecutor

    jm, jp, tm, tp = carried_models(name, use_pallas=True)
    jq, tq = queries(16, seed=2)
    want = np.asarray(JExecutor(jm, b_max=16, cse=cse).encode(jp, jq))
    got = _port_executor(tm, cse=cse).encode(tp, tq).numpy()
    np.testing.assert_allclose(got, want, **ENCODE)


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_batch_matches_reference(name):
    """Scores at the returned ids match the reference's, and the top-k ids
    are equal except where neighbouring scores lie within the tolerance."""
    from repro.core import PooledExecutor as JExecutor
    from repro.launch.serve import serve_batch as j_serve
    from repro_torch.launch.serve import serve_batch as t_serve

    jm, jp, tm, tp = carried_models(name, use_pallas=True)
    jq, tq = queries(12, seed=8)
    jex = JExecutor(jm, b_max=16)
    jres, _ = j_serve(jm, jp, jex, jq, top_k=5)
    tres, _ = t_serve(tm, tp, _port_executor(tm), tq, top_k=5, device="cpu")
    full = np.asarray(jm.score_all(jp, jex.encode(jp, jq, compiled=True)))
    tol = BETAE_DISTANCE if name == "betae" else FP32
    slack = tol["atol"] + 5e-4  # results carry scores rounded to 3 places
    for i, (j, t) in enumerate(zip(jres, tres)):
        assert t["pattern"] == j["pattern"]
        ids = np.asarray(t["top_entities"])
        np.testing.assert_allclose(t["scores"], full[i, ids],
                                   rtol=tol["rtol"], atol=slack)
        for a, b in zip(j["top_entities"], t["top_entities"]):
            if a != b:
                assert abs(full[i, a] - full[i, b]) <= tol["atol"] + tol["rtol"] * abs(full[i, a])


def _engine(name, **cfg):
    from repro_torch.serving import ServingConfig, ServingEngine

    _, _, tm, tp = carried_models(name)
    ex = _port_executor(tm)
    eng = ServingEngine(tm, tp, executor=ex, device="cpu",
                        cfg=ServingConfig(**cfg))
    return tm, tp, ex, eng


@pytest.mark.parametrize("name", FAMILIES)
def test_engine_replays_bitwise_through_serve_batch(name):
    from repro_torch.launch.serve import serve_batch
    from repro_torch.serving import check_against_offline

    tm, tp, ex, eng = _engine(name, record_batches=True, max_batch=8)
    _, tq = queries(24, seed=9)
    with eng:
        futures = eng.submit_many(tq[:10]) + [eng.submit(q) for q in tq[10:]]
        results = [f.result(timeout=60) for f in futures]
    assert all(len(r["top_entities"]) == 10 for r in results)
    assert all(np.isfinite(r["scores"]).all() for r in results)
    checked = check_against_offline(
        eng.batch_log,
        lambda qs: serve_batch(tm, tp, ex, qs, top_k=10, device="cpu")[0])
    assert checked == sum(rec.n_real for rec in eng.batch_log) > 0


def test_engine_zero_retraces_on_replay():
    from repro_torch.serving import run_closed_loop

    _, _, _, eng = _engine("gqe", max_batch=8)
    _, tq = queries(32, seed=10)
    with eng:
        run_closed_loop(eng, tq, concurrency=8)
        assert eng.retraces() > 0
        eng.reset_counters()
        report = run_closed_loop(eng, tq, concurrency=8)
        st = eng.stats()
    assert st["retraces"] == 0 and st["batches"] >= 4
    assert report.latency_ms["n"] == 32


def test_engine_isolates_poison_request():
    from repro_torch.core import QueryInstance

    _, _, _, eng = _engine("complex", max_batch=8, max_wait_ms=50.0)
    _, tq = queries(3, seed=11)
    bad = QueryInstance("no-such-pattern", np.array([1]), np.array([0]))
    with eng:
        futures = eng.submit_many(tq + [bad])
        good = [f.result(timeout=60) for f in futures[:3]]
        with pytest.raises(KeyError):
            futures[3].result(timeout=60)
    assert [r["pattern"] for r in good] == [q.pattern for q in tq]
    assert eng.stats()["failures"] == 1


def test_engine_coalesces_duplicates():
    _, _, _, eng = _engine("gqe", max_batch=8, max_wait_ms=50.0)
    _, tq = queries(2, seed=12)
    with eng:
        res = [f.result(timeout=60) for f in eng.submit_many([tq[0]] * 3 + [tq[1]])]
    assert res[0]["top_entities"] == res[1]["top_entities"] == res[2]["top_entities"]
    assert eng.stats()["coalesced"] == 2


def test_cli_serves_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--model", "betae", "--reduced", "--device", "cpu", "--dim", "8",
          "--requests", "24"])
    out = capsys.readouterr().out
    assert "[closed] 24 requests" in out and "0 steady-state retraces" in out


# ------------------------------------------------------- device defaults
def _call_without_device(entry):
    from repro_torch.core import PooledExecutor
    from repro_torch.launch.serve import main, serve_batch
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.serving import ServingEngine

    _, _, tm, tp = carried_models("gqe")
    if entry == "make_model":
        make_model("gqe", ModelConfig(dim=8))
    elif entry == "PooledExecutor":
        PooledExecutor(tm)
    elif entry == "ServingEngine":
        ServingEngine(tm, tp, executor=_port_executor(tm), started=False)
    elif entry == "serve_batch":
        serve_batch(tm, tp, _port_executor(tm), queries(2)[1])
    else:
        main(["--reduced", "--dim", "8", "--requests", "4"])


@pytest.mark.parametrize("entry", ["make_model", "PooledExecutor",
                                   "ServingEngine", "serve_batch", "cli"])
def test_entry_point_needs_a_gpu_unless_told_cpu(entry):
    """Without ``device=`` every entry point runs on cuda, and with no GPU it
    raises instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _call_without_device(entry)



def test_update_params_swaps_what_is_served():
    _, _, tm, tp = carried_models("gqe")
    _, tq = queries(4, seed=13)
    _, _, _, eng = _engine("gqe", max_batch=4, max_wait_ms=50.0)
    flipped = {k: (-v if k == "entity" else v) for k, v in tp.items()}
    with eng:
        before = [f.result(timeout=60) for f in eng.submit_many(tq)]
        eng.update_params(flipped)
        after = [f.result(timeout=60) for f in eng.submit_many(tq)]
    from repro_torch.launch.serve import serve_batch

    want, _ = serve_batch(tm, flipped, _port_executor(tm), tq, device="cpu")
    assert [r["top_entities"] for r in after] == [w["top_entities"] for w in want]
    assert [r["top_entities"] for r in after] != [r["top_entities"] for r in before]


def test_registry_snapshot_sees_engine_counters():
    from repro_torch.obs import get_registry

    _, _, _, eng = _engine("complex", max_batch=4, max_wait_ms=50.0)
    _, tq = queries(4, seed=14)
    before = get_registry().snapshot()
    with eng:
        [f.result(timeout=60) for f in eng.submit_many(tq)]
    snap = get_registry().snapshot()
    assert snap["serving_completed"] - before.get("serving_completed", 0) == 4
    assert snap["serving_latency_ms_count"] >= 4
    assert snap["cache_misses{cache=encode}"] >= 1
