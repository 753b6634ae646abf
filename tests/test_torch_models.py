"""Every operator of the port's six encoder families against the JAX
package's, on carried-across weights and the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import BETAE_DISTANCE, FP32, carried_models, to_torch

# All six encoder families of the reference (torch_parity.FAMILIES lists the
# three the serving slice began with).
FAMILIES = ["betae", "gqe", "complex", "q2b", "q2p", "fuzzqe"]

torch.set_num_threads(1)

OPS = ["embed", "project", "intersect2", "intersect3", "union", "negate",
       "distance", "score_ids", "score_all"]
# Outputs that pass through BetaE's betaln/digamma (see torch_parity).
_DISTANCE_OPS = {"distance", "score_ids", "score_all"}


def _run(model, params, op, ids, rel, ids2, to):
    """One operator on inputs built by the model itself from the same ids."""
    x = model.embed(params, to(ids))
    if op == "embed":
        return x
    if op == "project":
        return model.project(params, x, to(rel))
    if op.startswith("intersect") or op == "union":
        k = 2 if op in ("intersect2", "union") else 3
        X = model.embed(params, to(ids2[:, :k]))
        return (model.union if op == "union" else model.intersect)(params, X)
    if op == "negate":
        return model.negate(params, x)
    if op == "distance":
        return model.distance(params, x, params["entity"][to(ids2[:, 0])])
    if op == "score_ids":
        return model.score_ids(params, x, to(ids2))
    return model.score_all(params, x)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", FAMILIES)
def test_operator_matches_reference(name, op):
    jm, jp, tm, tp = carried_models(name)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 200, size=9)
    rel = rng.integers(0, 10, size=9)
    ids2 = rng.integers(0, 200, size=(9, 5))
    want = np.asarray(_run(jm, jp, op, ids, rel, ids2, jnp.asarray))
    with torch.no_grad():
        got = _run(tm, tp, op, ids, rel, ids2, to_torch).numpy()
    assert got.shape == want.shape
    tol = BETAE_DISTANCE if name == "betae" and op in _DISTANCE_OPS else FP32
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("name", FAMILIES)
def test_params_carry_reference_names(name):
    jm, jp, tm, tp = carried_models(name)
    assert set(tp) == set(jp)
    assert {k for k, _ in tm.named_parameters()} == set(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_match_reference_shapes(name):
    from repro_torch.models import ModelConfig, make_model

    jm, jp, _, _ = carried_models(name)
    tm = make_model(name, ModelConfig(dim=16), device="cpu")
    tp = tm.init_params(torch.Generator().manual_seed(0), 200, 10)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    assert tm.state_dim == jm.state_dim


def test_padded_entity_rows_masked():
    from repro_torch.models import ModelConfig, make_model

    tm = make_model("gqe", ModelConfig(dim=8, entity_pad=16), device="cpu")
    tp = tm.init_params(torch.Generator().manual_seed(0), 200, 10)
    assert tp["entity"].shape[0] == 208
    with torch.no_grad():
        s = tm.score_all(tp, tm.embed(tp, torch.tensor([1, 2])))
    assert (s[:, 200:] == -1e30).all() and (s[:, :200] > -1e29).all()


@pytest.mark.parametrize("name", FAMILIES)
def test_semantic_config_builds_and_fuses(name):
    """A semantic config builds, and its entity vectors are the Eq. 12
    fusion of the structural and semantic rows."""
    from repro_torch.models import ModelConfig, make_model

    tm = make_model(name, ModelConfig(dim=8, semantic_dim=4,
                                      semantic_proj_dim=2), device="cpu")
    table = np.random.default_rng(0).normal(size=(200, 4)).astype(np.float32)
    tp = tm.init_params(torch.Generator().manual_seed(0), 200, 10,
                        semantic_table=table)
    ids = torch.tensor([3, 7, 7, 150])
    P = {k: v.detach().numpy().astype(np.float64) for k, v in tp.items()}
    x = np.concatenate(
        [P["entity"][ids], table[ids] @ P["sem_proj_w"] + P["sem_proj_b"]], -1)
    want = 2.0 / (1.0 + np.exp(-(x @ P["fuse_w"] + P["fuse_b"]))) - 1.0
    with torch.no_grad():
        got = tm.fused_entity_vec(tp, ids)
        plain = tm.fuse_semantic(tp, tp["entity"][ids], tm.semantic_rows(tp, ids))
    assert got.shape == (4, 8) and (got.abs() < 1).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(plain, got, rtol=1e-6, atol=1e-6)
