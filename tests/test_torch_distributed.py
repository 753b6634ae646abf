"""The port's sharding rules, mesh-spec parsing, context description and int8
compression against the JAX package's, without processes (one subprocess
with 8 emulated XLA devices holds each rank's shard to the reference's
``devices_indices_map``)."""
import itertools
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.distributed import context as j_context
from repro.distributed import sharding as j_sharding
from repro_torch.distributed import context as t_context
from repro_torch.distributed import sharding as t_sharding


class FakeMesh:
    """Duck-typed mesh for rule tests (shape dict + axis_names)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
SPECS = ["data=1", "data=2", "data=4", "data=8", "data=4,model=2", "pod=2,data=2,model=2"]


def _meshes():
    return [FakeMesh({a: s for a, s in j_context.parse_mesh_spec(spec).items()})
            for spec in SPECS]


def _tuple(p):
    return tuple(p)


# ------------------------------------------------- tests/test_distributed.py
@pytest.mark.parametrize("dim,axis", [(64, "model"), (20, "model"), (1500, ("data", "model")),
                                      (512, ("data", "model")), (32, ("data", "model")),
                                      (7, None)])
def test_fit_divisibility(dim, axis):
    assert t_sharding._fit(dim, axis, MESH) == j_sharding._fit(dim, axis, MESH)


@pytest.mark.parametrize("name,shape,moe", [
    ("wq", (80, 8192, 8192), "tp"), ("wo", (80, 8192, 8192), "tp"),
    ("embed", (152064, 8192), "tp"), ("wq", (32, 1280, 1280), "tp"),
    ("wk", (24, 896, 128), "tp"), ("A_log", (48, 20), "tp"), ("A_log", (48, 64), "tp"),
    ("ln1", (80, 8192), "tp"), ("moe_up", (56, 8, 6144, 16384), "tp"),
    ("moe_up", (32, 16, 4096, 14336), "ep"), ("moe_down", (32, 16, 14336, 4096), "ep"),
    ("entity", (2_500_604, 400), "tp"), ("sem_cache", (2048, 1024), "tp")])
def test_param_spec_rules(name, shape, moe):
    want = j_sharding.param_spec(name, shape, MESH, moe)
    assert t_sharding.param_spec(name, shape, MESH, moe) == _tuple(want)


@pytest.mark.parametrize("name,shape", [("wq", (36, 2560, 4096)), ("ln1", (2560,)),
                                        ("embed", (1500, 4096)), ("sem_slot", (2_500_604,)),
                                        ("entity", (14951, 400))])
def test_fsdp_profile_spec(name, shape):
    want = j_sharding.fsdp_param_spec(name, shape, MESH)
    assert t_sharding.fsdp_param_spec(name, shape, MESH) == _tuple(want)


@pytest.mark.parametrize("profile", ["2d", "fsdp"])
def test_dp_axes_and_batch_spec(profile):
    for mesh in [MESH, MESH3, *_meshes()]:
        assert t_sharding.dp_axes(mesh, profile) == j_sharding.dp_axes(mesh, profile)
        for n in (1, 12, 16, 512, 513):
            want = j_sharding.batch_spec((n, 7), mesh, profile)
            assert t_sharding.batch_spec((n, 7), mesh, profile) == _tuple(want)
    assert t_sharding.batch_spec((), MESH) == ()
    tree = {"pos": np.zeros(16), "neg": [np.zeros((16, 4)), np.zeros((3, 2))]}
    assert t_sharding.batch_specs(tree, MESH, profile) == {
        "pos": _tuple(j_sharding.batch_spec((16,), MESH, profile)),
        "neg": [_tuple(j_sharding.batch_spec((16, 4), MESH, profile)),
                _tuple(j_sharding.batch_spec((3, 2), MESH, profile))]}


# ---------------------------------------- every NGDB parameter, every mesh
def _ngdb_shapes():
    """(family, semantic, {name: shape}) of every parameter at
    ``ModelConfig()`` widths on FB15k's entity count and its 8-padded
    twin, from the reference's ``init_params`` (shapes only), the hot-set
    layout's ``sem_cache``/``sem_slot`` added."""
    from repro.models import ModelConfig, make_model

    out = []
    for family, sem, n_ent in itertools.product(
            ["betae", "gqe", "complex", "q2b", "q2p", "fuzzqe"], [0, 1024], [14951, 14952]):
        model = make_model(family, ModelConfig(semantic_dim=sem))
        st = jax.ShapeDtypeStruct((n_ent, sem), np.float32) if sem else None
        shapes = jax.eval_shape(
            lambda k, s: model.init_params(k, n_ent, 1345, semantic_table=s),
            jax.random.PRNGKey(0), st)
        shapes = {k: tuple(v.shape) for k, v in shapes.items()}
        if sem:
            shapes.update({"sem_cache": (2048, sem), "sem_slot": (n_ent,)})
        out.append((family, sem, shapes))
    return out


NGDB = _ngdb_shapes()


@pytest.mark.parametrize("profile,moe", [("2d", "tp"), ("2d", "ep"), ("fsdp", "tp")])
@pytest.mark.parametrize("spec", SPECS)
def test_every_ngdb_parameter_spec_equals_the_reference(spec, profile, moe):
    mesh = FakeMesh(j_context.parse_mesh_spec(spec))
    for _, _, shapes in NGDB:
        for name, shape in shapes.items():
            if profile == "fsdp":
                want = j_sharding.fsdp_param_spec(name, shape, mesh)
            else:
                want = j_sharding.param_spec(name, shape, mesh, moe)
            got = t_sharding.profile_spec(name, shape, mesh, profile, moe)
            assert got == _tuple(want), (name, shape)


def test_param_specs_name_moments_by_their_parameter():
    mesh = FakeMesh({"data": 4, "model": 2})

    class Leaf:
        def __init__(self, shape):
            self.shape = shape

    tree = {"params": {"entity": Leaf((14952, 400)), "fuse_w": Leaf((464, 400))},
            "opt": {"m": {"entity": Leaf((14952, 400))}, "v": {"entity": Leaf((14952, 400))},
                    "step": Leaf(())}}
    got = t_sharding.param_specs(tree, mesh, "fsdp")
    ent = _tuple(j_sharding.fsdp_param_spec("entity", (14952, 400), mesh))
    assert got["opt"]["m"]["entity"] == got["opt"]["v"]["entity"] == ent
    assert got["params"]["fuse_w"] == _tuple(j_sharding.fsdp_param_spec("fuse_w", (464, 400),
                                                                        mesh))
    assert got["opt"]["step"] == ()


# ----------------------------------------------------- parse and describe
@pytest.mark.parametrize("spec", SPECS + [
    "data=4, model=2", "model=2,data=3", "data=2,", "pod=1,data=1",
    "", "data", "data=x", "data=0", "data=2,data=2", "model=2", "tensor=2", "data=-1"])
def test_parse_mesh_spec_equals_the_reference(spec):
    try:
        want = j_context.parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_context.parse_mesh_spec(spec)
        assert str(got.value) == str(e)
        return
    assert t_context.parse_mesh_spec(spec) == want
    assert list(t_context.parse_mesh_spec(spec)) == list(want)


@pytest.mark.parametrize("profile", ["2d", "fsdp"])
def test_describe_and_sizes_equal_the_reference(profile):
    assert (t_context.ExecutionContext.single_device().describe()
            == j_context.ExecutionContext.single_device().describe())
    for spec in SPECS:
        sizes = j_context.parse_mesh_spec(spec)
        mesh = FakeMesh({a: sizes[a] for a in ("pod", "data", "model") if a in sizes})
        want = j_context.ExecutionContext.from_mesh(mesh, profile=profile)
        got = t_context.ExecutionContext.from_mesh(mesh, profile=profile)
        assert got.describe() == want.describe()
        assert (got.dp_size, got.is_sharded) == (want.dp_size, want.is_sharded)
    with pytest.raises(ValueError, match="profile must be 2d|fsdp"):
        t_context.ExecutionContext.from_mesh(MESH, profile="3d")


def test_make_execution_context_without_a_group_names_torchrun():
    assert not t_context.ExecutionContext.single_device().is_sharded
    assert t_context.make_execution_context(None).describe() == "single-device"
    with pytest.raises(ValueError, match="world size 8.*torchrun --nproc-per-node 8"):
        t_context.make_execution_context("data=4,model=2", device="cpu")


def test_put_batch_takes_this_ranks_rows():
    for rank in range(4):
        mesh = _rank_mesh({"data": 4, "model": 1}, rank)
        mesh.device = torch.device("cpu")
        ctx = t_context.ExecutionContext.from_mesh(mesh, profile="fsdp")
        got = ctx.put_batch(np.arange(16) * 10)
        assert torch.equal(got, torch.arange(4 * rank, 4 * rank + 4) * 10)
        # 18 rows do not divide 4 ways (nor does a prefix): every rank, all rows
        assert torch.equal(ctx.put_batch(np.arange(18)), torch.arange(18))
        assert torch.equal(ctx.put_replicated(np.arange(3)), torch.arange(3))


def test_single_device_helpers_pass_values_through():
    ctx = t_context.ExecutionContext.single_device()
    t = torch.arange(6.0).reshape(3, 2)
    assert ctx.shard("entity", t) is t and ctx.gather("entity", t, (3, 2)) is t
    np.testing.assert_array_equal(ctx.batch_rows(5), np.arange(5))
    assert ctx.reduce_batch(t, 3) is t and ctx.gather_rows(t, 3) is t
    assert ctx.rank == 0 and ctx.batch_axes(5) == ()


def test_trainer_refuses_a_context_without_donation():
    """The trainer updates parameters and moments in place, which is what
    ``donate_params=True`` means; False is refused, not ignored."""
    from repro_torch.data import generate_synthetic_kg
    from repro_torch.models import ModelConfig, make_model
    from repro_torch.training import NGDBTrainer, TrainConfig

    kg = generate_synthetic_kg(64, 4, 300, seed=0)
    model = make_model("gqe", ModelConfig(dim=8), device="cpu")
    ctx = t_context.ExecutionContext(donate_params=False)
    assert ctx.describe() == j_context.ExecutionContext(donate_params=False).describe()
    with pytest.raises(ValueError, match="donate_params=False is not supported"):
        NGDBTrainer(model, kg, TrainConfig(batch_size=8, n_negatives=2, prefetch=0), ctx=ctx)


# ------------------------------------------------------------ compression
def test_quantize_int8_bitwise_the_reference():
    from repro.training import compression as j_comp
    from repro_torch.training import compression as t_comp

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000,)).astype(np.float32)
    # values whose x/scale lands on .5: round half to even in both
    x[:8] = np.float32(127.0) * np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 3.5, 1.0],
                                         np.float32) / np.float32(127.0)
    x[8] = 1.0
    for arr in (x, np.zeros(4, np.float32), x * 1e-20):
        jq, js = j_comp.quantize_int8(jax.numpy.asarray(arr))
        tq, ts = t_comp.quantize_int8(torch.from_numpy(arr))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert tq.dtype == torch.int8 and ts.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(t_comp.dequantize_int8(tq, ts).numpy(),
                                      np.asarray(j_comp.dequantize_int8(jq, js)))


def test_bubble_fraction_equals_the_reference():
    from repro.distributed import bubble_fraction as j_bubble
    from repro_torch.distributed import bubble_fraction as t_bubble

    for s, m in [(2, 8), (4, 4), (1, 3), (8, 32)]:
        assert t_bubble(s, m) == j_bubble(s, m)


# -------------------------------------- shards against devices_indices_map
_SHARDS = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, numpy as np
from repro.distributed.context import make_execution_context
from repro.distributed.sharding import cache_shardings
out = []
for spec, profile in [("data=8", "fsdp"), ("data=4,model=2", "2d"), ("data=4,model=2", "fsdp"),
                      ("pod=2,data=2,model=2", "fsdp"), ("data=2,model=4", "2d")]:
    ctx = make_execution_context(spec, profile=profile)
    devs = list(ctx.mesh.devices.flat)
    for name, shape in [("entity", (14952, 400)), ("sem_table", (14952, 1024)),
                        ("fuse_w", (464, 400)), ("att_w1", (800, 800)), ("relation", (1345, 400))]:
        m = ctx.param_sharding(name, shape).devices_indices_map(shape)
        idx = [[[s.start or 0, shape[d] if s.stop is None else s.stop]
                for d, s in enumerate(m[dev])] for dev in devs]
        out.append([spec, profile, name, list(shape), idx])
    for shape in [(4, 8, 128, 2, 16), (4, 1, 4096, 2, 16), (2, 16, 8)]:
        sh = cache_shardings({"k": jax.ShapeDtypeStruct(shape, np.float32)}, ctx.mesh)["k"]
        out.append([spec, "cache", "k", list(shape),
                    [list(e) if isinstance(e, tuple) else e for e in sh.spec]])
print(json.dumps(out))
"""


def _rank_mesh(shape, rank):
    """The port's ``ProcessMesh`` seen from ``rank`` of a row-major grid of
    ``shape``, without a process group: the placement helpers only read
    its shape and coordinates."""
    mesh = t_context.ProcessMesh.__new__(t_context.ProcessMesh)
    mesh.shape, mesh.axis_names = dict(shape), tuple(shape)
    mesh.size, mesh.rank = int(np.prod(list(shape.values()))), rank
    grid = np.arange(mesh.size).reshape(tuple(shape.values()))
    mesh._coords = {r: dict(zip(mesh.axis_names, (int(i) for i in np.argwhere(grid == r)[0])))
                    for r in range(mesh.size)}
    return mesh


def test_each_rank_shard_is_the_reference_devices_indices_map():
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _SHARDS], capture_output=True, text=True,
                          timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = json.loads(proc.stdout.splitlines()[-1])
    checked = 0
    for spec, profile, name, shape, idx in rows:
        sizes = t_context.parse_mesh_spec(spec)
        shape_axes = {a: sizes[a] for a in ("pod", "data", "model") if a in sizes}
        if profile == "cache":
            mesh = FakeMesh(shape_axes)
            want = tuple(tuple(e) if isinstance(e, list) else e for e in idx)
            assert t_sharding.cache_spec(tuple(shape), mesh) == want, (spec, shape)
            continue
        full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        for rank, box in enumerate(idx):
            ctx = t_context.ExecutionContext.from_mesh(_rank_mesh(shape_axes, rank),
                                                       profile=profile)
            want = full[tuple(slice(a, b) for a, b in box)]
            assert torch.equal(ctx.shard(name, full), want), (spec, profile, name, rank)
            checked += 1
    assert checked == 5 * 5 * 8
