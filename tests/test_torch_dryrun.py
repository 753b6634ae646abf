"""The dry run of the port (``repro_torch.launch.{dryrun,mesh,roofline,report}``,
``repro_torch.lm.shapes``) against the JAX package's
(``repro.launch.*``, ``repro.lm.shapes``):

* the shape cells: ``SHAPES``, ``cell_supported`` and every input's shape
  (and dtype: the port's token ids are int64) for all 40 cells, 33 runnable
  and 7 skipped;
* the roofline math: ``_wire_bytes``, ``model_flops``, and ``roofline_terms``
  against the reference's formulas under the H100's constants;
  ``collective_stats`` on the five collectives of
  ``tests/test_launch.py::_HLO`` against ``parse_collectives``;
* ``report``'s tables line for line against the reference's on one record
  set (the reference's lower and compile columns are the port's trace);
* ``make_host_mesh`` as ``tests/test_distributed.py`` pins the reference's;
* on reduced architectures, the dry run's FLOPs (meta tensors) equal
  ``FlopCounterMode`` over the same step on CPU tensors, and the k = 2 / k = 3
  extrapolation lies within 0.1% of the whole program's count;
* qwen2-0.5b ``train_4k`` and the ``--ngdb`` cell (dense and row-sparse), each
  at production scale on the 16×16 virtual mesh, give complete records with
  no real allocation."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ARCHS

COMPLETE = ("memory", "cost_raw", "collectives_raw", "cost_exact", "roofline",
            "model_flops_global", "model_flops_per_device", "useful_flops_ratio", "trace_s")
MEMORY = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes")


# ------------------------------------------------------------ shape cells
def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def test_shape_cells_match_reference():
    from repro.lm import shapes as js
    from repro_torch.configs import ARCHS as T_ARCHS
    from repro_torch.lm import shapes as ts

    assert {k: dataclasses.asdict(v) for k, v in ts.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in js.SHAPES.items()}
    runnable = skipped = 0
    for name, cfg in ARCHS.items():
        for shape in js.SHAPES:
            want = js.cell_supported(cfg, shape)
            assert ts.cell_supported(T_ARCHS[name], shape) == want
            if want:
                skipped += 1
                continue
            runnable += 1
            ref = {k: v for k, v in _leaves(js.input_specs(cfg, shape)).items()}
            got = _leaves(ts.input_specs(T_ARCHS[name], shape))
            assert set(got) == set(ref), (name, shape)
            for k, r in ref.items():
                g = got[k]
                if k == "cache_len":  # an int: the cache's last slot
                    assert g == js.SHAPES[shape].seq_len - 1
                    continue
                assert g.device.type == "meta" and tuple(g.shape) == tuple(r.shape), (name, k)
                want_dtype = "int64" if str(r.dtype) == "int32" else str(r.dtype)
                assert str(g.dtype).replace("torch.", "") == want_dtype, (name, k)
    assert runnable == 33 and skipped == 7


# ------------------------------------------------------------------ roofline
def test_wire_bytes_and_model_flops_match_reference():
    from repro.launch import roofline as jr
    from repro.lm.shapes import SHAPES
    from repro_torch.configs import ARCHS as T_ARCHS
    from repro_torch.launch import roofline as tr

    for op in ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
               "collective-permute", "send-done"):
        for size in (0, 100, 12345):
            for g in (1, 2, 16, 512):
                assert tr._wire_bytes(op, size, g) == jr._wire_bytes(op, size, g)
    for name, cfg in ARCHS.items():
        for shape, cell in SHAPES.items():
            assert tr.model_flops(T_ARCHS[name], cell, cell.kind) == jr.model_flops(
                cfg, cell, cell.kind)


@pytest.mark.parametrize("terms", [(1e15, 1e12, 1e9), (1e12, 1e13, 0.0), (1e9, 1e9, 1e12)])
def test_roofline_terms_are_the_reference_formulas_at_h100_peaks(monkeypatch, terms):
    """With the reference's constants set to the H100's (ICI = NVLink), its
    ``roofline_terms`` and the port's give the same terms; InfiniBand bytes
    add their own time."""
    from repro.launch import roofline as jr
    from repro_torch.launch import roofline as tr

    monkeypatch.setattr(jr, "PEAK_FLOPS", tr.PEAK_FLOPS)
    monkeypatch.setattr(jr, "HBM_BW", tr.HBM_BW)
    monkeypatch.setattr(jr, "ICI_BW", tr.NVLINK_BW)
    want = jr.roofline_terms(*terms)
    got = tr.roofline_terms(*terms)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12), k
    assert (tr.PEAK_FLOPS, tr.HBM_BW, tr.NVLINK_BW, tr.IB_BW) == (989e12, 3.35e12, 450e9, 50e9)
    both = tr.roofline_terms(terms[0], terms[1], {"nvlink": terms[2], "ib": 2e9})
    assert both["collective_s"] == pytest.approx(terms[2] / tr.NVLINK_BW + 2e9 / tr.IB_BW)
    assert both["collective_tiers"]["ib_s"] == pytest.approx(2e9 / tr.IB_BW)


def test_collective_stats_match_parse_collectives():
    """The five collectives of ``tests/test_launch.py::_HLO`` as a virtual
    mesh's log: counts, bytes by type, wire and payload bytes equal
    ``parse_collectives``'."""
    from repro.launch.roofline import parse_collectives
    from repro_torch.launch.roofline import collective_stats
    from test_launch import _HLO

    log = [{"op": "all_gather", "group": 16, "result_bytes": 16 * 512 * 1024 * 2},
           {"op": "all_reduce", "group": 4, "result_bytes": 256 * 128 * 4},
           {"op": "reduce_scatter", "group": 16, "result_bytes": 64 * 128 * 4},
           {"op": "send", "group": 2, "result_bytes": 8 * 4, "spans_hosts": True},
           {"op": "recv", "group": 2, "result_bytes": 8 * 4, "spans_hosts": True},
           {"op": "all_to_all", "group": 8, "result_bytes": 4 * 4 * 2}]
    want = parse_collectives(_HLO, total_devices=256)
    got = collective_stats(log, 256)
    assert got.counts == want.counts
    assert got.by_type == pytest.approx(want.by_type)
    assert got.wire_bytes == pytest.approx(want.wire_bytes)
    assert got.payload_bytes == pytest.approx(want.payload_bytes)
    assert got.by_tier["ib"] == 32.0
    assert got.by_tier["nvlink"] == pytest.approx(want.wire_bytes - 32.0)


def test_virtual_mesh_logs_its_collectives_by_host():
    """On the 16×16 mesh rank 0's model group (ranks 0-15) spans two hosts of
    8, its data group sixteen; counts and bytes are ``ProcessMesh``'s
    (received bytes for an all-gather)."""
    from repro_torch.distributed.context import VirtualMesh
    from repro_torch.launch.mesh import make_production_mesh

    m = make_production_mesh()
    t = torch.empty((4, 8), device="meta")
    assert m.all_gather_tensor(t, ("model",)).shape == (16, 4, 8)
    m.all_reduce(t, ("data",))
    assert m.reduce_scatter(torch.empty((32, 8), device="meta"), ("model",), 0).shape == (2, 8)
    assert [(e["op"], e["group"], e["result_bytes"], e["spans_hosts"]) for e in m.log] == [
        ("all_gather", 16, 16 * 128, True), ("all_reduce", 16, 128, True),
        ("reduce_scatter", 16, 64, True)]
    assert m.stats()["counts"] == {"all_gather": 1, "all_reduce": 1, "reduce_scatter": 1}
    assert m.bytes["all_gather"] == 16 * 128
    mp = make_production_mesh(multi_pod=True)
    assert mp.shape == {"pod": 2, "data": 16, "model": 16} and mp.members(("model",)) == tuple(
        range(16))
    assert VirtualMesh(mp.shape, 7).members(("model",)) == tuple(range(16))


# -------------------------------------------------------------------- report
def _records():
    """One record set: an ok cell, a skipped one, an error, a raw one, and
    the rest missing."""
    base = {"kind": "train", "trace_s": 3.5, "lower_s": 1.2, "compile_s": 2.3,
            "memory": {"peak_bytes": 12_345_678_901},
            "collectives_raw": {"counts": {"all-gather": 3, "all-reduce": 5},
                                "by_type": {"all-gather": 5.0, "all-reduce": 9.0}},
            "cost_exact": {"collective_by_type": {"all-gather": 5.0, "all-reduce": 9.0}},
            "roofline": {"compute_s": 1.5, "memory_s": 0.0123, "collective_s": 2e-5,
                         "dominant": "compute"},
            "model_flops_per_device": 1.5e14, "useful_flops_ratio": 0.73}
    decode = dict(base, kind="decode", roofline=dict(base["roofline"], dominant="memory",
                                                     memory_s=4.0))
    coll = dict(base, roofline=dict(base["roofline"], dominant="collective", collective_s=9.0))
    raw = {k: v for k, v in base.items() if k != "cost_exact"}
    return {"qwen2-0.5b_train_4k_sp": base, "qwen2-0.5b_decode_32k_sp": decode,
            "qwen3-4b_train_4k_sp": coll, "qwen3-4b_prefill_32k_sp": raw,
            "qwen2-72b_long_500k_sp": {"skipped": "full-attention arch"},
            "qwen2-72b_train_4k_sp": {"error": "boom"},
            "qwen2-0.5b_train_4k_mp": base}


def test_report_tables_match_reference_line_for_line():
    from repro.launch import report as jrep
    from repro_torch.launch import report as trep

    recs = _records()
    for suffix in ("sp", "mp"):
        want = jrep.dryrun_table(recs, suffix)
        got = trep.dryrun_table(recs, suffix)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            # The reference's lower and compile columns are the port's trace.
            w = (w.replace("| lower | compile |", "| trace |")
                 .replace("|---|---|---|---|---|---|---|", "|---|---|---|---|---|---|")
                 .replace("| 1.2s | 2.3s |", "| 3.5s |").replace("| | | | |", "| | | |")
                 .replace("(raw program)", "(whole program)"))
            assert g == w
    assert trep.roofline_table(recs) == jrep.roofline_table(recs)
    assert "not measured" in trep.header() and "H100 SXM published peaks, 700 W" in trep.header()


def test_report_cli_prints_from_the_out_directory(tmp_path, capsys):
    import json

    from repro_torch.launch import report

    for tag, rec in _records().items():
        (tmp_path / f"{tag}.json").write_text(json.dumps(rec))
    report.main([str(tmp_path)])
    out = capsys.readouterr().out
    assert "Reckoned, not measured" in out and "| qwen2-0.5b | train_4k | ok | 3.5s |" in out


# ---------------------------------------------------------------- host mesh
def test_make_host_mesh_as_the_reference_pins_it():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    was = dist.is_initialized()
    try:
        n = dist.get_world_size() if was else 1
        mesh = make_host_mesh(model_parallel=1, device="cpu")
        assert mesh.shape == {"data": n, "model": 1}
        with pytest.raises(ValueError) as ei:
            make_host_mesh(model_parallel=n + 1, device="cpu")
        assert str(n) in str(ei.value)
        assert "xla_force_host_platform_device_count" in str(ei.value)
        with pytest.raises(ValueError):
            make_host_mesh(model_parallel=0, device="cpu")
    finally:
        if not was and dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------------------------------ counts
def _reduced(name, **over):
    from repro_torch.configs import ARCHS as T_ARCHS, reduced_config

    return dataclasses.replace(reduced_config(T_ARCHS[name]), **over)


@pytest.mark.parametrize("name", ["mixtral-8x22b", "qwen3-4b", "whisper-large-v3"])
@pytest.mark.parametrize("shape", [{"data": 1, "model": 1}, {"data": 2, "model": 2}])
def test_meta_flops_equal_flop_counter_on_cpu(name, shape):
    """The same train step (a virtual mesh's rank 1 program, or the whole
    one on a 1×1 mesh) run on CPU tensors under ``FlopCounterMode`` and on
    meta tensors through the dry run's counters: equal FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import ExecutionContext, VirtualMesh
    from repro_torch.distributed.sharding import dp_axes
    from repro_torch.launch.dryrun import measure
    from repro_torch.lm.model import init_params
    from repro_torch.lm.steps import lm_adam_init, make_train_step

    cfg = _reduced(name)
    rank = 1 if len(shape) and shape["model"] > 1 else 0
    rng = np.random.default_rng(0)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (4, 32)),
             "tokens": rng.integers(0, cfg.vocab_size, (4, 32))}
    if cfg.is_encdec:
        batch["encoder_frames"] = rng.normal(size=(4, cfg.encoder_seq, cfg.d_model)) * 0.05
    flops = {}
    for dev in ("cpu", "meta"):
        mesh = VirtualMesh(shape, rank, device=dev)
        ctx = ExecutionContext.from_mesh(mesh, profile="2d", moe_mode=cfg.moe_mode)
        params = ctx.shard_tree(init_params(cfg, seed=0, device=dev))
        b = {k: torch.as_tensor(v, dtype=torch.bfloat16 if v.dtype.kind == "f" else None)
             .to(dev) for k, v in batch.items()}
        step = make_train_step(cfg, mesh, dp_axes(mesh, "2d"))
        args = (params, lm_adam_init(params), b)
        if dev == "cpu":
            with FlopCounterMode(display=False) as fc:
                step(*args)
            flops[dev] = fc.get_total_flops()
        else:
            flops[dev] = measure(step, args, 0, mesh)["flops"]
    assert flops["cpu"] > 0 and flops["meta"] == flops["cpu"]


@pytest.mark.parametrize("name,over,shape", [
    ("qwen3-4b", {"n_layers": 6}, "train_4k"),
    ("jamba-v0.1-52b", {"n_layers": 32}, "decode_32k"),
    ("whisper-large-v3", {"n_layers": 4, "encoder_layers": 4}, "train_4k")])
def test_k_extrapolation_is_within_a_tenth_of_a_percent(name, over, shape):
    """The reference's k = 2 / k = 3 (k = 1 / 2 for jamba's 8-layer blocks)
    extrapolation against the whole program's count on the 16×16 mesh:
    FLOPs, bytes and wire bytes within 0.1%."""
    from repro_torch.launch.dryrun import run_cell

    rec = run_cell(name, shape, cfg=_reduced(name, **over))
    whole, ext = rec["cost_exact"], rec["cost_extrapolated"]
    assert ext["blocks_extrapolated"] >= 4
    for key in ("flops", "bytes_accessed", "wire_bytes"):
        assert whole[key] > 0
        assert abs(ext[key] - whole[key]) <= 1e-3 * whole[key], (key, ext[key], whole[key])


# ----------------------------------------------------------- production cells
def _no_real_allocation():
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


def test_qwen2_0_5b_train_4k_on_the_production_mesh():
    """A complete record at published width on the 16×16 virtual mesh: the
    reference's keys, memory parts that add up, every collective priced and
    spanning hosts (groups of 16), FLOPs above the model's useful FLOPs a
    device, and the process's resident memory far below the state it
    reckons."""
    from repro_torch.launch.dryrun import run_cell

    before = _no_real_allocation()
    rec = run_cell("qwen2-0.5b", "train_4k", analyze=False)
    assert all(k in rec for k in COMPLETE), set(COMPLETE) - set(rec)
    mem = rec["memory"]
    assert all(mem[k] >= 0 for k in MEMORY)
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                 + mem["output_bytes"] - mem["alias_bytes"])
    assert mem["alias_bytes"] > 0                      # params and moments in place
    coll = rec["collectives_raw"]
    assert coll["counts"]["all-gather"] > 0 and coll["counts"]["all-reduce"] > 0
    assert coll["by_tier"]["ib"] == pytest.approx(coll["wire_bytes"])
    assert 0 < rec["useful_flops_ratio"] < 1
    assert rec["roofline"]["constants"] == "H100 SXM published peaks, 700 W"
    grown_kb = _no_real_allocation() - before
    assert grown_kb * 1024 < mem["peak_bytes"] / 10


@pytest.mark.parametrize("sparse", [False, True])
def test_ngdb_cell_on_the_production_mesh(sparse):
    """The paper's BetaE step at ogbl-wikikg2 scale (d_l 1024), dense (the
    port's ``NGDBTrainer._step``) and row-sparse: complete records, the
    kernels reached on meta and reckoned (forward and backward), and the
    dense step gathering the whole entity and semantic tables a rank."""
    from repro_torch.launch.dryrun import run_ngdb_cell

    rec = run_ngdb_cell(sparse_updates=sparse)
    for k in ("memory", "cost", "collectives", "roofline", "schedule_stats", "kernels"):
        assert k in rec, k
    assert set(rec["kernels"]) == {"intersect", "intersect_backward", "gather_fuse",
                                   "gather_fuse_backward"}
    assert all(v["calls"] > 0 and v["flops"] > 0 for v in rec["kernels"].values())
    mem = rec["memory"]
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                 + mem["output_bytes"] - mem["alias_bytes"])
    tables = (2_502_656 * 400 + 2_502_656 * 1024) * 4   # rows padded to 4,096
    if sparse:
        assert mem["peak_bytes"] < tables
    else:
        assert mem["peak_bytes"] > tables


def test_kernel_wrappers_on_meta_reckon_and_launch_nothing():
    """Each wrapper on meta tensors: an empty meta result of the kernel's
    shape (its backward too, under autograd), the kernel's FLOPs and bytes
    handed to the hook as ``PERF.md``'s bound column counts them, and no
    launch counted."""
    from repro_torch.kernels import ops, reckon

    seen = []
    saved, reckon.HOOK = reckon.HOOK, lambda *a: seen.append(a)
    launches = [f.launches for f in (ops.scoring, ops.intersect, ops.intersect_backward,
                                     ops.gather_fuse, ops.gather_fuse_backward)]
    try:
        def m(*shape):
            return torch.empty(shape, device="meta")

        s = ops.scoring(m(4, 16), m(50, 16), 1.0, "l1")
        x, w1 = m(8, 2, 16).requires_grad_(), m(16, 32).requires_grad_()
        y = ops.intersect(x, w1, m(32), m(32, 1), m(1))
        y.sum().backward()
        ids = torch.empty(10, dtype=torch.long, device="meta")
        h = m(50, 16).requires_grad_()
        z = ops.gather_fuse(ids, h, m(50, 8), m(8, 4), m(4), m(20, 16), m(16))
        z.sum().backward()
    finally:
        reckon.HOOK = saved
    assert (s.shape, y.shape, z.shape) == ((4, 50), (8, 16), (10, 16))
    assert all(t.device.type == "meta" for t in (s, y, z, x.grad, w1.grad, h.grad))
    assert (x.grad.shape, w1.grad.shape, h.grad.shape) == ((8, 2, 16), (16, 32), (50, 16))
    assert [name for name, _, _ in seen] == ["scoring", "intersect", "intersect_backward",
                                             "gather_fuse", "gather_fuse_backward"]
    assert seen[0][1:] == (3 * 4 * 50 * 16, (4 * 16 + 50 * 16) * 4 + 4 * 50 * 4)
    assert seen[1][1] == 8 * 2 * (2 * 16 * 32 + 4 * 32 + 2 * 16)
    assert [f.launches for f in (ops.scoring, ops.intersect, ops.intersect_backward,
                                 ops.gather_fuse, ops.gather_fuse_backward)] == launches
