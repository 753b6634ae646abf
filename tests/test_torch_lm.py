"""The port's LM zoo (``repro_torch.lm``, ``repro_torch.configs``) against the
JAX package's ``repro.lm`` on the same numpy inputs and carried weights.

* every case of ``tests/test_lm_modules.py``, each run through both
  packages' functions (fp32: rtol 1e-5, atol 1e-5 unless stated), with the
  reference's own invariant held on the port;
* MoE routing on inputs built with exact ties: the reference's experts and
  its dropped tokens, exactly;
* each of the ten ``reduced_config`` architectures, both packages on the
  same carried weights (the port's ``init_params``; the reference's carried
  across by ``lm_params_from_numpy`` too): forward hidden states, logits,
  ``chunked_ce_loss``, prefill caches and logits, decode logits, and one
  train step's loss, Adam moments and update, each in bf16 (the default)
  and with compute in fp32 (``COMPUTE_DTYPE`` patched in both packages):
  - fp32: every output within rtol 1e-4, atol 1e-4 (measured: <= 3.62e-5,
    jamba's caches), the losses within 1e-5; step 1's ``m`` = (1-b1)·g and
    ``v`` = (1-b2)·g² of every leaf norm-wise within 1e-4 (measured: m
    <= 2.34e-5, v <= 3.49e-5, both jamba's ``A_log``), so the gradient of
    every leaf is held; the update norm-wise within 0.5 (measured <= 0.147,
    jamba's ``ssm_norm``: a first step moves an element by about
    lr·sign(g), and a gradient within rounding of 0 may take either sign).
    A negated gradient puts m 2 off, a zeroed one 1, a detached
    ``exp(segsum)`` in ``ssd_scan`` 1.3-1.6 (``dt_bias``);
  - bf16: hidden states, logits and caches within rtol 2e-2, atol 1e-1
    (measured: <= 0.109, mamba2's hidden states; a few bf16 steps at
    |x| ~ 4), the losses within 1e-2 (measured: <= 1.3e-3), m and v
    norm-wise within 0.15 (measured: <= 0.0635 and 0.0933, mamba2's
    ``D_skip``). The MoE architectures (grok, mixtral, jamba) route
    near-tied tokens to other experts in bf16 (rounding of the router's
    input; measured: hidden rows off by up to 1.49, logits 2.36, m 1.1), so
    of theirs only the loss is held in bf16, within 5e-2 (measured:
    <= 0.0133);
* the reference's invariants on the port: prefill plus decode equals
  forward (its bf16 tolerance, rtol 5e-2, atol 5e-1), parameter counts
  and the full configs (the mesh branches: ``tests/test_torch_lm_mesh.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced_config

torch.set_num_threads(1)
B, S = 2, 32
FP32 = dict(rtol=1e-5, atol=1e-5)
# The MoE architectures: in bf16 their near-tied tokens may route to other
# experts than the reference's (docstring).
FLIPS = tuple(n for n in sorted(ARCHS) if ARCHS[n].is_moe)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ modules
@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    b, s, h, kv, hd = 2, 64, 8, 2, 16
    return tuple(rng.normal(size=(b, s, n, hd)).astype(np.float32) for n in (h, kv, kv))


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("mode", ["dense", "blockwise", "dense_chunked"])
def test_attention_modes_match_reference(qkv, mode, window):
    """Each mode against the reference's same mode (1e-5), and the port's
    against the materialized-repeat oracle of ``test_lm_modules.py``
    (its 2e-4)."""
    from repro.lm import attention as ja
    from repro_torch.lm import attention as ta

    kw = dict(causal=True, window=window)
    if mode == "blockwise":
        kw.update(q_chunk=16, kv_chunk=16)
    elif mode == "dense_chunked":
        kw.update(q_chunk=16)
    name = f"{mode}_attention"
    want = np.asarray(getattr(ja, name)(*(jnp.asarray(a) for a in qkv), **kw))
    got = getattr(ta, name)(*(_t(a) for a in qkv), **kw).numpy()
    np.testing.assert_allclose(got, want, **FP32)
    q, k, v = (jnp.asarray(a) for a in qkv)
    rep = q.shape[2] // k.shape[2]
    kr, vr = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(q.shape[-1])
    pos = jnp.arange(q.shape[1])
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    oracle = jnp.einsum("bhqk,bkhd->bqhd",
                        jax.nn.softmax(jnp.where(mask, logits, -1e30), axis=-1), vr)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(qkv, dtype):
    """One step against the cache: against the reference's (fp32 1e-5;
    bf16 one bf16 step, 1e-2 of the output's scale) and against the dense
    last row (2e-4)."""
    from repro.lm import attention as ja
    from repro_torch.lm import attention as ta

    q, k, v = qkv
    s = q.shape[1]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    lens = np.full((2,), s, np.int32)
    want = ja.decode_attention(jnp.asarray(q[:, -1:], jd), jnp.asarray(k, jd),
                               jnp.asarray(v, jd), jnp.asarray(lens))
    got = ta.decode_attention(_t(q[:, -1:], td), _t(k, td), _t(v, td), _t(lens))
    tol = FP32 if dtype == "float32" else dict(rtol=0, atol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    if dtype == "float32":
        dense = ta.dense_attention(_t(q), _t(k), _t(v))[:, -1:]
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-4, atol=2e-4)


def test_rope_matches_reference_and_preserves_inner_products():
    from repro.lm.modules import apply_rope as j_rope
    from repro_torch.lm.modules import apply_rope as t_rope

    rng = np.random.default_rng(0)
    hd = 32
    q = rng.normal(size=(1, 1, 1, hd)).astype(np.float32)
    k = rng.normal(size=(1, 1, 1, hd)).astype(np.float32)
    dots = []
    for base in (0, 17):
        qr = t_rope(_t(q), torch.tensor([[base + 5]]), 10000.0)
        kr = t_rope(_t(k), torch.tensor([[base]]), 10000.0)
        np.testing.assert_allclose(
            qr.numpy(), np.asarray(j_rope(jnp.asarray(q), jnp.array([[base + 5]]), 10000.0)),
            **FP32)
        dots.append(float(torch.sum(qr * kr)))
    assert abs(dots[0] - dots[1]) < 1e-3


def test_segsum_matches_reference():
    from repro.lm.mamba2 import segsum as j_segsum
    from repro_torch.lm.mamba2 import segsum

    a = np.array([[1.0, 2.0, 3.0]], np.float32)
    got = segsum(_t(a))[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(j_segsum(jnp.asarray(a)))[0])
    assert got[0, 0] == 0.0 and got[2, 0] == 5.0 and np.isneginf(got[0, 2])


def _ssd_inputs(rng, b, t, h, p, n, scale=0.5):
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    dtA = (-np.abs(rng.normal(size=(b, t, h))) * scale).astype(np.float32)
    bm = rng.normal(size=(b, t, 1, n)).astype(np.float32)
    cm = rng.normal(size=(b, t, 1, n)).astype(np.float32)
    return x, dtA, bm, cm


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_scan_matches_reference_and_recurrence(chunk):
    """Chunked SSD against the reference's (outputs and final state, 1e-5
    of their scale) and against the port's token-by-token recurrence
    (the reference's 1e-3)."""
    from repro.lm.mamba2 import ssd_scan as j_scan
    from repro_torch.lm.mamba2 import ssd_decode_step, ssd_scan

    x, dtA, bm, cm = _ssd_inputs(np.random.default_rng(0), 2, 16, 4, 8, 8)
    y, final = ssd_scan(_t(x), _t(dtA), _t(bm), _t(cm), chunk)
    jy, jf = j_scan(*(jnp.asarray(a) for a in (x, dtA, bm, cm)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(final.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-4)
    state = torch.zeros((2, 4, 8, 8))
    ys = []
    for i in range(16):
        yi, state = ssd_decode_step(state, _t(x[:, i]), _t(dtA[:, i]), _t(bm[:, i]),
                                    _t(cm[:, i]))
        ys.append(yi)
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(), rtol=1e-3, atol=1e-3)


def test_ssd_state_handoff():
    """Prefill then decode equals one long prefill (state continuity), and
    each decode step equals the reference's."""
    from repro.lm.mamba2 import ssd_decode_step as j_step
    from repro_torch.lm.mamba2 import ssd_decode_step, ssd_scan

    x, dtA, bm, cm = _ssd_inputs(np.random.default_rng(1), 1, 12, 2, 4, 4, scale=0.3)
    y_full, _ = ssd_scan(_t(x), _t(dtA), _t(bm), _t(cm), chunk=4)
    y_pre, state = ssd_scan(_t(x[:, :8]), _t(dtA[:, :8]), _t(bm[:, :8]), _t(cm[:, :8]), chunk=4)
    ys = [y_pre]
    for i in range(8, 12):
        jy, _ = j_step(jnp.asarray(state.numpy()), *(jnp.asarray(a[:, i])
                                                     for a in (x, dtA, bm, cm)))
        y, state = ssd_decode_step(state, _t(x[:, i]), _t(dtA[:, i]), _t(bm[:, i]),
                                   _t(cm[:, i]))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FP32)
        ys.append(y[:, None])
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(), rtol=1e-3, atol=1e-3)


def test_causal_conv_matches_reference_and_lax():
    from repro.lm.mamba2 import causal_conv as j_conv
    from repro_torch.lm.mamba2 import causal_conv

    rng = np.random.default_rng(0)
    b, t, c, k = 2, 10, 6, 4
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    w = rng.normal(size=(k, c)).astype(np.float32)
    bias = np.zeros((c,), np.float32)
    y, _ = causal_conv(_t(x), _t(w), _t(bias))
    jy, _ = j_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FP32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x).transpose(0, 2, 1)[:, :, None, :], jnp.asarray(w).T[:, None, None, :],
        (1, 1), [(0, 0), (k - 1, 0)], feature_group_count=c,
        dimension_numbers=("NCHW", "OIHW", "NCHW"))[:, :, 0, :].transpose(0, 2, 1)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_causal_conv_streaming():
    """conv(full) == conv(prefix) + a streamed conv with carried state."""
    from repro_torch.lm.mamba2 import causal_conv

    rng = np.random.default_rng(0)
    b, t, c, k = 1, 9, 4, 4
    x = _t(rng.normal(size=(b, t, c)).astype(np.float32))
    w = _t(rng.normal(size=(k, c)).astype(np.float32))
    bias = torch.zeros((c,))
    full, _ = causal_conv(x, w, bias)
    y1, st = causal_conv(x[:, :5], w, bias)
    outs = [y1]
    for i in range(5, t):
        y, st = causal_conv(x[:, i:i + 1], w, bias, st)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), **FP32)


def test_moe_pack_combine_roundtrip():
    """Ample capacity: the identity expert gives x back, and the packing is
    the reference's exactly."""
    from repro.lm.moe import pack_by_expert as j_pack
    from repro_torch.lm.moe import combine_from_experts, pack_by_expert

    rng = np.random.default_rng(0)
    t, d, e, k, cap = 32, 8, 4, 2, 32
    x = rng.normal(size=(t, d)).astype(np.float32)
    eidx = rng.integers(0, e, (t, k))
    gates = np.full((t, k), 1.0 / k, np.float32)
    packed, meta = pack_by_expert(_t(x), _t(eidx), _t(gates), e, cap)
    jpacked, jmeta = j_pack(jnp.asarray(x), jnp.asarray(eidx), jnp.asarray(gates), e, cap)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(meta[0].numpy(), np.asarray(jmeta[0]))
    y = combine_from_experts(packed, meta, t)
    np.testing.assert_allclose(y.numpy(), x, **FP32)


def test_moe_capacity_drops():
    from repro_torch.lm.moe import combine_from_experts, pack_by_expert

    t, d, e = 16, 4, 2
    packed, meta = pack_by_expert(torch.ones((t, d)), torch.zeros((t, 1), dtype=torch.int32),
                                  torch.ones((t, 1)), e, capacity=4)
    y = combine_from_experts(packed, meta, t)
    assert float(y.sum() / d) == 4.0   # the pool at its fill limit: overflow dropped
    assert y[:4].sum() == 4 * d and y[4:].sum() == 0   # the first four in token order


def test_moe_routing_on_ties_is_the_reference_exactly():
    """Router columns built equal in pairs, so every token's probabilities tie
    between experts 0/1 and 2/3, and some tokens' inputs are zero, so all
    four tie: the port picks the reference's experts (the lower index first),
    keeps the reference's tokens at a capacity that drops some, and gives
    its output."""
    from repro.lm import moe as jmoe
    from repro_torch.lm import moe as tmoe

    rng = np.random.default_rng(3)
    t, d, f, e, k = 24, 8, 16, 4, 2
    x = rng.normal(size=(t, d)).astype(np.float32)
    x[::5] = 0.0
    col = rng.normal(size=(d, 2)).astype(np.float32)
    router = np.stack([col[:, 0], col[:, 0], col[:, 1], col[:, 1]], axis=1)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1))
    jg, je = jax.lax.top_k(jnp.asarray(probs), k)
    tg, te = tmoe.top_k(_t(probs), k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert (np.asarray(je)[:, 0] < np.asarray(je)[:, 1]).any()
    cap = 5   # below t·k/e = 12: tokens are dropped
    jp, jm = jmoe.pack_by_expert(jnp.asarray(x), je, jg, e, cap)
    tp, tm = tmoe.pack_by_expert(_t(x), te, tg, e, cap)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm[0]))
    assert (tm[0].numpy() == e * cap).sum() > 0
    w = [rng.normal(size=s).astype(np.float32) / 4 for s in ((e, d, f), (e, d, f), (e, f, d))]
    cfg = dataclasses.replace(reduced_config(ARCHS["mixtral-8x22b"]), n_experts=e,
                              top_k=k, capacity_factor=cap * e / (t * k))
    want = jmoe.moe_ffn(jnp.asarray(x), jnp.asarray(router), *(jnp.asarray(a) for a in w), cfg)
    got = tmoe.moe_ffn(_t(x), _t(router), *(_t(a) for a in w), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_rms_norm():
    from repro.lm.modules import rms_norm as j_rms
    from repro_torch.lm.modules import rms_norm

    x = np.array([[3.0, 4.0]], np.float32)
    y = rms_norm(_t(x), torch.ones(2), eps=0.0)
    np.testing.assert_allclose(float(torch.mean(y ** 2)), 1.0, rtol=1e-5)
    xb = np.random.default_rng(0).normal(size=(16, 64)).astype(np.float32) * 3
    scale = np.random.default_rng(1).normal(size=(64,)).astype(np.float32)
    got = rms_norm(_t(xb, torch.bfloat16), _t(scale))
    want = j_rms(jnp.asarray(xb, jnp.bfloat16), jnp.asarray(scale))
    np.testing.assert_array_equal(_np(got), _np(want))   # bitwise in bf16


def test_activations_are_the_reference_bits_in_bf16():
    """``silu`` and ``gelu`` round where the reference's bf16 ops round."""
    from repro_torch.lm.modules import gelu, silu

    x = np.random.default_rng(0).normal(size=(4096,)).astype(np.float32) * 3
    xb = _t(x, torch.bfloat16)
    for t_fn, j_fn in ((silu, jax.nn.silu), (gelu, jax.nn.gelu)):
        np.testing.assert_array_equal(_np(t_fn(xb)), _np(j_fn(jnp.asarray(x, jnp.bfloat16))))


# ------------------------------------------------------------ architectures
def _batch(cfg, dtype):
    rng = np.random.default_rng(0)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        b["embeddings"] = (rng.normal(size=(B, S, cfg.d_model)) * 0.05).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.is_encdec:
        b["encoder_frames"] = (rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
                               * 0.05).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jb = {k: jnp.asarray(v, jd) if v.dtype == np.float32 else jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(v, td) if v.dtype == np.float32 else _t(v) for k, v in b.items()}
    return jb, tb


def _run(name, dtype):
    """Both packages on one reduced architecture from the same weights (the
    port's ``init_params`` as numpy, carried into both): {output: (port,
    reference)}. The reference's outputs come from one compiled program."""
    from repro.lm import model as jm
    from repro.lm import steps as js
    from repro_torch.configs import ARCHS as T_ARCHS, reduced_config as t_reduced
    from repro_torch.lm import model as tm
    from repro_torch.lm import steps as ts

    cfg = reduced_config(ARCHS[name])
    tcfg = t_reduced(T_ARCHS[name])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    saved = jm.COMPUTE_DTYPE, tm.COMPUTE_DTYPE
    if dtype == "fp32":
        jm.COMPUTE_DTYPE, tm.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        arrays = _to_numpy(tm.init_params(tcfg, seed=0, device="cpu"))
        jp = jax.tree.map(jnp.asarray, arrays)
        jb, tb = _batch(cfg, dtype)
        tok = np.zeros((B, 1), np.int32)
        # The reference's adam_init is zeros like every leaf (nothing is
        # frozen in LM_ADAM).
        zeros = jax.tree.map(np.zeros_like, arrays)
        opt = {"m": zeros, "v": zeros, "step": np.zeros((), np.int32)}

        def reference(p, opt, b):
            h, _ = jm.forward(p, cfg, **js._forward_kwargs(cfg, b))
            out = {"hidden": h, "logits": jm.logits_fn(p, cfg, h),
                   "ce": jm.chunked_ce_loss(p, cfg, h, b["labels"])}
            out["params"], out["opt"], out["loss"] = js.make_train_step(cfg)(p, opt, b)
            c, out["prefill"] = js.make_prefill_step(cfg, cache_margin=8)(p, b)
            out["caches"] = c
            out["decode"], _ = js.make_decode_step(cfg)(p, c, jnp.asarray(tok), jnp.int32(S))
            return out

        want = jax.jit(reference)(jp, opt, jb)
        tp = tm.lm_params_from_numpy(arrays, device="cpu")
        out = {}
        with torch.no_grad():
            th, _ = tm.forward(tp, tcfg, **ts._forward_kwargs(tcfg, tb))
            out["hidden"] = th
            out["logits"] = tm.logits_fn(tp, tcfg, th)
            out["ce"] = tm.chunked_ce_loss(tp, tcfg, th, tb["labels"])
        tp2 = tm.lm_params_from_numpy(arrays, device="cpu")
        _, opt, out["loss"] = ts.make_train_step(tcfg)(tp2, ts.lm_adam_init(tp2), tb)
        before = ts.flatten(arrays)
        # Step 1's moments, (1-b1)·g and (1-b2)·g², and the update, leaf by leaf.
        out["m"], out["v"] = opt["m"], opt["v"]
        out["update"] = {k: v.numpy() - before[k] for k, v in ts.flatten(tp2).items()}
        want["m"], want["v"] = (ts.flatten(jax.tree.map(np.asarray, want["opt"][key]))
                                for key in ("m", "v"))
        want["update"] = {k: v - before[k] for k, v in ts.flatten(
            jax.tree.map(np.asarray, want["params"])).items()}
        tc, out["prefill"] = ts.make_prefill_step(tcfg, cache_margin=8)(tp, tb)
        out["caches"] = ts.flatten(tc)
        want["caches"] = ts.flatten(jax.tree.map(np.asarray, want["caches"]))
        out["decode"], _ = ts.make_decode_step(tcfg)(tp, tc, _t(tok), S)
        res = {k: (out[k], want[k]) for k in out}
        res["struct"] = ({k: (tuple(v.shape), v.dtype) for k, v in ts.flatten(
            ts.cache_struct(tcfg, B, S + 8, abstract=False, device="cpu")).items()},
            {k: (tuple(v.shape), str(v.dtype)) for k, v in ts.flatten(
                js.cache_struct(cfg, B, S + 8)).items()})
        return res
    finally:
        jm.COMPUTE_DTYPE, tm.COMPUTE_DTYPE = saved


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


def test_lm_params_from_numpy_carries_the_reference_init():
    """The reference's ``init_params`` output comes across with its tree,
    names, shapes and values (qwen2-0.5b's reduced configuration)."""
    from repro.lm.model import init_params as j_init
    from repro_torch.configs import ARCHS as T_ARCHS, reduced_config as t_reduced
    from repro_torch.lm.model import lm_params_from_numpy
    from repro_torch.lm.steps import flatten

    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    ref = flatten(jax.tree.map(np.asarray, jax.jit(lambda k: j_init(cfg, k))(
        jax.random.PRNGKey(0))))
    got = flatten(lm_params_from_numpy(ref, device="cpu"))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert dataclasses.asdict(t_reduced(T_ARCHS["qwen2-0.5b"])) == dataclasses.asdict(cfg)


def _gap(got, want) -> float:
    """Norm-wise relative gap of one leaf: ||got - want|| / ||want||."""
    g, w = _np(got).ravel().astype(np.float64), np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


# Step 1's Adam moments, leaf by leaf (norm-wise): m = (1-b1)·g holds the
# gradient itself, v = (1-b2)·g² its size. A negated gradient is 2 off, a
# zero one 1.
MOMENT_TOL = {"fp32": 1e-4, "bf16": 0.15}
# The update of a first Adam step is about lr·sign(g): gradients within
# rounding of 0 may take either sign, so only the fp32 update is held.
UPDATE_TOL = 0.5


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_reduced_arch_matches_reference(name, dtype):
    out = _run(name, dtype)
    flips = dtype == "bf16" and name in FLIPS
    if flips:
        np.testing.assert_allclose(float(out["loss"][0]), float(out["loss"][1]), rtol=0, atol=5e-2)
        return
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "fp32" else dict(rtol=2e-2, atol=1e-1)
    loss_tol = 1e-5 if dtype == "fp32" else 1e-2
    for key in ("hidden", "logits", "prefill", "decode"):
        got, want = out[key]
        assert np.isfinite(_np(got)).all(), key
        np.testing.assert_allclose(_np(got), _np(want), err_msg=key, **tol)
    for key in ("ce", "loss"):
        np.testing.assert_allclose(float(out[key][0]), float(out[key][1]), rtol=0,
                                   atol=loss_tol, err_msg=key)
    for key in ("m", "v", "update"):
        got, want = out[key]
        assert set(got) == set(want), key
        if key == "update" and dtype == "bf16":
            continue
        limit = UPDATE_TOL if key == "update" else MOMENT_TOL[dtype]
        gaps = {k: _gap(got[k], want[k]) for k in want}
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= limit, (key, worst, gaps[worst])
    got, want = out["caches"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), err_msg=k, **tol)
    tstruct, jstruct = out["struct"]
    assert {k: s for k, (s, _) in tstruct.items()} == {k: s for k, (s, _) in jstruct.items()}
    assert {k: str(d).replace("torch.", "") for k, (_, d) in tstruct.items()} == {
        k: d for k, (_, d) in jstruct.items()}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_decode_matches_forward(name):
    """The reference's invariant on the port, for every architecture (bf16,
    its tolerance): decode of input S after prefill of S inputs gives
    forward's logits at S. MoE archs get an ample capacity, as the
    reference's test gives them; whisper's prefill and forward see the same
    encoder frames; llava's prefix is embeddings, its input S the embedding
    of the token decode is given."""
    from repro_torch.configs import ARCHS as T_ARCHS, reduced_config as t_reduced
    from repro_torch.lm.model import forward, init_params, logits_fn
    from repro_torch.lm.steps import flatten, make_decode_step, make_prefill_step

    cfg = t_reduced(T_ARCHS[name])
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    params = init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    toks = _t(rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    kw, prefix = {"tokens": toks}, {"tokens": toks[:, :S]}
    if cfg.frontend == "vision":
        emb = _t((rng.normal(size=(B, S + 1, cfg.d_model)) * 0.05).astype(np.float32))
        emb[:, S] = params["embed"][toks[:, S]]
        kw, prefix = {"embeddings": emb}, {"embeddings": emb[:, :S]}
    if cfg.is_encdec:
        frames = _t((rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)) * 0.05)
                    .astype(np.float32), torch.bfloat16)
        kw["enc_frames"] = prefix["encoder_frames"] = frames
    with torch.no_grad():
        hidden, _ = forward(params, cfg, **kw)
        ref = logits_fn(params, cfg, hidden[:, -1:])
    caches, _ = make_prefill_step(cfg, cache_margin=8)(params, prefix)
    got, caches2 = make_decode_step(cfg)(params, caches, toks[:, S:], S)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=5e-2, atol=5e-1)
    assert ({k: v.shape for k, v in flatten(caches).items()}
            == {k: v.shape for k, v in flatten(caches2).items()})


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_counts_match_reference_and_analytic(name):
    """The port's tree holds the reference's leaves at the reference's shapes;
    the count is within the reference's 5% of ``param_count()`` where its
    test checks that (qwen2-0.5b, mamba2-1.3b, mixtral-8x22b)."""
    from repro.lm.model import abstract_params
    from repro_torch.configs import ARCHS as T_ARCHS, reduced_config as t_reduced
    from repro_torch.lm.model import init_params
    from repro_torch.lm.steps import flatten

    cfg = t_reduced(T_ARCHS[name])
    params = flatten(init_params(cfg, seed=0, device="cpu"))
    ref = flatten(jax.tree.map(lambda a: a, abstract_params(reduced_config(ARCHS[name]))))
    assert {k: tuple(v.shape) for k, v in params.items()} == {k: tuple(v.shape)
                                                              for k, v in ref.items()}
    assert all(v.dtype == torch.float32 for v in params.values())
    real = sum(v.numel() for v in params.values())
    if name in ("qwen2-0.5b", "mamba2-1.3b", "mixtral-8x22b"):
        assert abs(real - cfg.param_count()) / real < 0.05


def test_full_configs_match_assignment():
    from repro_torch.configs import ARCHS as T_ARCHS

    assert {k: dataclasses.asdict(v) for k, v in T_ARCHS.items()} == {
        k: dataclasses.asdict(v) for k, v in ARCHS.items()}
    a = T_ARCHS["qwen2-72b"]
    assert (a.n_layers, a.d_model, a.n_heads, a.n_kv_heads, a.d_ff,
            a.vocab_size) == (80, 8192, 64, 8, 29568, 152064)
    g = T_ARCHS["grok-1-314b"]
    assert g.n_experts == 8 and g.top_k == 2 and g.d_ff == 32768
    assert T_ARCHS["jamba-v0.1-52b"].attn_every == 8
    assert T_ARCHS["mamba2-1.3b"].ssm_state == 128 and T_ARCHS["mamba2-1.3b"].n_heads == 0
    assert T_ARCHS["whisper-large-v3"].encoder_seq == 1500
    assert T_ARCHS["mixtral-8x22b"].sliding_window > 0


def test_train_step_moves_params_and_remat_is_the_same_step():
    """One step moves the embedding; with ``remat`` (activations recomputed
    in the backward) the loss and updated parameters are bitwise the step
    without it."""
    from repro_torch.configs import ARCHS as T_ARCHS, reduced_config as t_reduced
    from repro_torch.lm.model import init_params
    from repro_torch.lm.steps import flatten, lm_adam_init, make_train_step

    cfg = t_reduced(T_ARCHS["jamba-v0.1-52b"])
    _, tb = _batch(cfg, "bf16")
    outs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        p = init_params(c, seed=0, device="cpu")
        before = p["embed"].clone()
        _, _, loss = make_train_step(c)(p, lm_adam_init(p), tb)
        assert float((p["embed"] - before).abs().max()) > 0
        outs.append((float(loss), flatten(p)))
    assert outs[0][0] == outs[1][0]
    for k, v in outs[0][1].items():
        assert torch.equal(v, outs[1][1][k]), k
