"""Composable decoder stack covering the zoo's 10 architectures, as the JAX
package's ``lm/model.py`` builds and runs it.

Layers are grouped into a repeating *block pattern* (length P = lcm of the
attention-interleave and MoE-interleave periods); parameters are stacked
[n_rep, ...] per pattern position with the reference's tree and names, and
``forward`` runs the stack as the reference's scan does: one loop over the
repetitions, each through the pattern's layers (under
``torch.utils.checkpoint`` a repetition when ``cfg.remat`` and training).

Parameters are fp32 masters; compute is bf16 (``COMPUTE_DTYPE``), cast at
each use as the reference casts (``x @ w.to(x.dtype)``), with norms,
softmaxes, RoPE and the SSM recurrence in fp32 where it upcasts.

Execution modes:
  * train/prefill  — full-sequence forward (prefill also returns caches)
  * decode         — one token against caches (attn KV / SWA ring / SSM state)

Given a ``mesh`` (a ``ProcessMesh``, or the dry run's ``VirtualMesh``) and
its profile's ``dp_axes``, ``forward`` and ``encode_frames`` run one rank's
program on its rows of the batch and its shards of the parameters
(``lm/parallel.py``: FSDP gathers, tensor parallelism over ``model`` in the
``2d`` profile, ``seq_shard``); with none, nothing of that runs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.lm.attention import attention, decode_attention
from repro_torch.lm.config import LMConfig
from repro_torch.lm.mamba2 import mamba_mixer
from repro_torch.lm.modules import apply_rope, gelu, init_dense, rms_norm, silu
from repro_torch.lm.moe import moe_ffn, moe_partial

COMPUTE_DTYPE = torch.bfloat16


# --------------------------------------------------------------------- pattern
def block_pattern(cfg: LMConfig) -> List[Tuple[str, str]]:
    """[(mixer, ffn)] for one repeating block."""
    kinds = cfg.layer_kinds()
    moe_every = 1 if (cfg.is_moe and not cfg.is_hybrid) else (2 if cfg.is_moe else 0)
    period = 1
    if cfg.is_hybrid:
        period = np.lcm(cfg.attn_every, moe_every or 1)
    pattern = []
    for i in range(int(period)):
        mixer = kinds[i] if i < len(kinds) else kinds[-1]
        if moe_every and (i % moe_every == moe_every - 1 if moe_every > 1 else True):
            ffn = "moe"
        elif cfg.d_ff > 0:
            ffn = "dense"
        else:
            ffn = "none"
        pattern.append((mixer, ffn))
    return pattern


def n_repeats(cfg: LMConfig) -> int:
    p = len(block_pattern(cfg))
    assert cfg.n_layers % p == 0, (cfg.n_layers, p)
    return cfg.n_layers // p


# ----------------------------------------------------------------------- init
def _dev(gen) -> torch.device:
    return gen if isinstance(gen, torch.device) else gen.device


def _init_attn_layer(gen, cfg: LMConfig, cross: bool = False) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    prefix = "x" if cross else ""
    dev = _dev(gen)
    p = {
        f"{prefix}wq": init_dense(gen, (d, h * hd)),
        f"{prefix}wk": init_dense(gen, (d, kv * hd)),
        f"{prefix}wv": init_dense(gen, (d, kv * hd)),
        f"{prefix}wo": init_dense(gen, (h * hd, d)),
    }
    if cfg.qkv_bias and not cross:
        p[f"{prefix}bq"] = torch.zeros((h * hd,), device=dev)
        p[f"{prefix}bk"] = torch.zeros((kv * hd,), device=dev)
        p[f"{prefix}bv"] = torch.zeros((kv * hd,), device=dev)
    if cfg.qk_norm and not cross:
        p["qnorm"] = torch.ones((hd,), device=dev)
        p["knorm"] = torch.ones((hd,), device=dev)
    return p


def _init_ffn(gen, cfg: LMConfig, kind: str) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    dev = _dev(gen)
    if kind == "moe":
        e = cfg.n_experts
        return {
            "router": init_dense(gen, (d, e)),
            "moe_gate": init_dense(gen, (e, d, f)),
            "moe_up": init_dense(gen, (e, d, f)),
            "moe_down": init_dense(gen, (e, f, d)),
        }
    if kind == "dense":
        if cfg.learned_pos:  # whisper-style gelu MLP with bias
            return {
                "w_up": init_dense(gen, (d, f)),
                "b_up": torch.zeros((f,), device=dev),
                "w_down": init_dense(gen, (f, d)),
                "b_down": torch.zeros((d,), device=dev),
            }
        return {
            "w_gate": init_dense(gen, (d, f)),
            "w_up": init_dense(gen, (d, f)),
            "w_down": init_dense(gen, (f, d)),
        }
    return {}


def _init_ssm_layer(gen, cfg: LMConfig) -> Dict:
    d = cfg.d_model
    din, g, n, nh = cfg.d_inner, 1, cfg.ssm_state, cfg.ssm_heads
    conv_dim = din + 2 * g * n
    dev = _dev(gen)
    return {
        "in_proj": init_dense(gen, (d, 2 * din + 2 * g * n + nh)),
        "conv_w": init_dense(gen, (cfg.ssm_conv, conv_dim), in_axis=0),
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "dt_bias": torch.zeros((nh,), device=dev),
        "A_log": torch.zeros((nh,), device=dev),
        "D_skip": torch.ones((nh,), device=dev),
        "ssm_norm": torch.ones((din,), device=dev),
        "out_proj": init_dense(gen, (din, d)),
    }


def _init_layer(gen, cfg: LMConfig, mixer: str, ffn: str, cross: bool = False) -> Dict:
    p: Dict = {"ln1": torch.ones((cfg.d_model,), device=_dev(gen))}
    if mixer == "attn":
        p.update(_init_attn_layer(gen, cfg))
    else:
        p.update(_init_ssm_layer(gen, cfg))
    if cross:
        p["ln_x"] = torch.ones((cfg.d_model,), device=_dev(gen))
        p.update(_init_attn_layer(gen, cfg, cross=True))
    if ffn != "none":
        p["ln2"] = torch.ones((cfg.d_model,), device=_dev(gen))
        p.update(_init_ffn(gen, cfg, ffn))
    return p


def _stacked(make, reps: int) -> Dict:
    """{leaf: [reps, ...]} of ``reps`` layers drawn in turn by ``make()``,
    each copied into the stack before the next is drawn (one layer beside
    the stack at a time, not all of them; a single layer is the stack)."""
    if reps == 1:
        return {k: v.unsqueeze(0) for k, v in make().items()}
    out: Dict = {}
    for r in range(reps):
        layer = make()
        for k, v in layer.items():
            if r == 0:
                out[k] = v.new_empty((reps,) + tuple(v.shape))
            if v.device.type != "meta":
                out[k][r].copy_(v)
        del layer
    return out


def init_params(cfg: LMConfig, seed: int = 0, device=None) -> Dict:
    """The full parameter tree in fp32 (the reference's names and nesting,
    every block leaf stacked [n_rep, ...]), drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (``cuda`` unless given) with the
    reference's distributions. The reference's ``fold_in`` streams cannot be
    reproduced; parity tests carry its weights (``lm_params_from_numpy``)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    # On the meta device a "generator" is the device itself (shapes only).
    gen = dev if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    vp, d = cfg.padded_vocab(), cfg.d_model
    params: Dict[str, Any] = {
        "embed": init_dense(gen, (vp, d), in_axis=-1).mul_(0.02).mul_(np.sqrt(d)),
        "final_norm": torch.ones((d,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, (d, vp))
    if cfg.learned_pos:
        params["pos_embed"] = init_dense(gen, (cfg.learned_pos, d), in_axis=-1).mul_(0.02)
    reps = n_repeats(cfg)
    blocks = {}
    for pi, (mixer, ffn) in enumerate(block_pattern(cfg)):
        cross = cfg.is_encdec and mixer == "attn"
        blocks[f"pos{pi}"] = _stacked(
            lambda: _init_layer(gen, cfg, mixer, ffn, cross), reps)  # noqa: B023
    params["blocks"] = blocks
    if cfg.is_encdec:
        params["enc"] = {
            "layers": _stacked(lambda: _init_layer(gen, cfg, "attn", "dense"),
                               cfg.encoder_layers),
            "pos_embed": init_dense(gen, (cfg.encoder_seq, d), in_axis=-1).mul_(0.02),
            "final_norm": torch.ones((d,), device=dev),
        }
    return params


def abstract_params(cfg: LMConfig) -> Dict:
    """The parameter tree's shapes and dtypes without allocation: meta
    tensors."""
    return init_params(cfg, device="meta")


def lm_params_from_numpy(tree: Mapping, device=None) -> Dict:
    """The reference's ``init_params`` output (``jax.tree.map(np.asarray,
    ...)``) as the port's tree: the same nesting, fp32 tensors on ``device``
    (``cuda`` unless given)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return torch.tensor(np.asarray(node, dtype=np.float32), device=dev)

    return walk(tree)


def param_bytes(params) -> int:
    """Bytes of every tensor in a parameter (or cache) tree."""
    if isinstance(params, Mapping):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


def _rep_slice(tree, r: int):
    """Repetition ``r`` of a tree stacked [n_rep, ...]."""
    if isinstance(tree, Mapping):
        return {k: _rep_slice(v, r) for k, v in tree.items()}
    return tree[r]


def _stack_trees(trees: List):
    if isinstance(trees[0], Mapping):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# -------------------------------------------------------------------- forward
def _attn_block(x, lp, cfg: LMConfig, positions, kv_in=None,
                cache=None, cache_len=None, cross=False, causal=True,
                pad_cache_to=None, par=None, heads=None):
    """Self- or cross-attention sublayer (pre-norm, residual outside).

    Returns (out, cache_updates): the entries to merge into this layer's
    cache (None when cache is None). Split over model (``heads``, a
    ``parallel.Heads`` of ``par``), ``out`` is this rank's partial sum and
    the caches hold every KV head."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    pre = "x" if cross else ""
    mode = "dense_chunked" if cfg.exact_cost_mode else "auto"
    own_kv = all_kv = lambda t: t  # noqa: E731
    if heads is not None:
        h = heads.h
        x = par.copy_in(x)
        if kv_in is not None:
            kv_in = par.copy_in(kv_in)
        if heads.kv_split:
            kv = heads.kv
            all_kv = par.all_heads

        def own_kv(t):  # the KV heads this rank's query heads attend with
            return t[:, :, heads.kv0:heads.kv0 + heads.kv]
    q = x @ lp[f"{pre}wq"].to(x.dtype)
    if f"{pre}bq" in lp:
        q = q + lp[f"{pre}bq"].to(x.dtype)
    q = q.reshape(b, s, h, hd)

    updates = None
    if cross:
        if cache is not None and "xk" in cache:
            k, v = own_kv(cache["xk"]), own_kv(cache["xv"])  # precomputed encoder KV
        else:
            k = (kv_in @ lp[f"{pre}wk"].to(x.dtype)).reshape(b, -1, kv, hd)
            v = (kv_in @ lp[f"{pre}wv"].to(x.dtype)).reshape(b, -1, kv, hd)
            if cache is not None:  # prefill: persist the encoder KV
                updates = {"xk": all_kv(k), "xv": all_kv(v)}
            if heads is not None and not heads.kv_split:
                k, v = own_kv(k), own_kv(v)
        out = attention(q, k, v, causal=False, mode=mode)
        return out.reshape(b, s, h * hd) @ lp[f"{pre}wo"].to(x.dtype), updates

    k = x @ lp["wk"].to(x.dtype)
    v = x @ lp["wv"].to(x.dtype)
    if "bk" in lp:
        k = k + lp["bk"].to(x.dtype)
        v = v + lp["bv"].to(x.dtype)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["qnorm"], cfg.norm_eps)
        k = rms_norm(k, lp["knorm"], cfg.norm_eps)
    if not cfg.learned_pos:  # RoPE archs (absolute positions; ring-safe)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and s == 1:  # decode: write KV at the ring/linear slot
        s_cache = cache["k"].shape[1]
        pos = cache_len % s_cache if cfg.sliding_window else cache_len
        # dynamic_update_slice clamps the start so the update fits.
        pos = min(max(int(pos), 0), s_cache - s)
        ck = cache["k"].clone()
        cv = cache["v"].clone()
        ck[:, pos:pos + s] = all_kv(k)
        cv[:, pos:pos + s] = all_kv(v)
        eff = int(cache_len) + 1
        if cfg.sliding_window:
            eff = min(eff, s_cache)  # the ring bounds the window
        lens = torch.full((b,), eff, dtype=torch.int32, device=x.device)
        out = decode_attention(q, own_kv(ck), own_kv(cv), lens)
        return out.reshape(b, s, h * hd) @ lp["wo"].to(x.dtype), {"k": ck, "v": cv}

    if cache is not None:  # prefill: the computed KV becomes the cache
        ka, va = all_kv(k), all_kv(v)
        if cfg.sliding_window and k.shape[1] > cfg.sliding_window:
            updates = {"k": ka[:, -cfg.sliding_window:], "v": va[:, -cfg.sliding_window:]}
        else:
            ck, cv = ka, va
            if pad_cache_to and pad_cache_to > s:  # capacity for later decodes
                pad = (0, 0, 0, 0, 0, pad_cache_to - s)
                ck = torch.nn.functional.pad(ka, pad)
                cv = torch.nn.functional.pad(va, pad)
            updates = {"k": ck, "v": cv}
    if heads is not None and not heads.kv_split:
        k, v = own_kv(k), own_kv(v)
    out = attention(q, k, v, causal=causal, window=cfg.sliding_window, mode=mode)
    return out.reshape(b, s, h * hd) @ lp["wo"].to(x.dtype), updates


def _ffn_block(x, lp, cfg: LMConfig, kind: str, par=None, split=False):
    """The MLP or MoE sublayer. Split over model (``split``, under ``par``)
    it returns (this rank's partial sum, the bias to add after the sum);
    otherwise its output."""
    if split:
        if kind == "moe":
            return moe_partial(x, lp["router"].to(x.dtype), lp["moe_gate"].to(x.dtype),
                               lp["moe_up"].to(x.dtype), lp["moe_down"].to(x.dtype), cfg,
                               par), None
        x = par.copy_in(x)
        if "w_gate" in lp:
            return (silu(x @ lp["w_gate"].to(x.dtype))
                    * (x @ lp["w_up"].to(x.dtype))) @ lp["w_down"].to(x.dtype), None
        return (gelu(x @ lp["w_up"].to(x.dtype) + lp["b_up"].to(x.dtype))
                @ lp["w_down"].to(x.dtype)), lp["b_down"].to(x.dtype)
    if kind == "moe":
        return moe_ffn(x, lp["router"].to(x.dtype), lp["moe_gate"].to(x.dtype),
                       lp["moe_up"].to(x.dtype), lp["moe_down"].to(x.dtype), cfg)
    if "w_gate" in lp:
        return (silu(x @ lp["w_gate"].to(x.dtype))
                * (x @ lp["w_up"].to(x.dtype))) @ lp["w_down"].to(x.dtype)
    return (gelu(x @ lp["w_up"].to(x.dtype) + lp["b_up"].to(x.dtype))
            @ lp["w_down"].to(x.dtype) + lp["b_down"].to(x.dtype))


def _layer(x, lp, cfg, mixer, ffn, positions, enc_out=None, cache=None,
           cache_len=None, causal=True, pad_cache_to=None, par=None, path="",
           last=False):
    """One layer. Under ``par`` its shards ``lp`` (of ``path``) become the
    tensors it computes with (``MeshPlan.layer``), and where ``last`` its
    final residual sum leaves this rank's S block (``seq_shard``)."""
    layout = None
    if par is not None:
        lp, layout = par.layer(lp, path, mixer, ffn, mixer == "attn" and "xwq" in lp)
    cache_out = dict(cache) if cache is not None else None
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if mixer == "attn":
        out, upd = _attn_block(h, lp, cfg, positions, cache=cache,
                               cache_len=cache_len, causal=causal,
                               pad_cache_to=pad_cache_to, par=par,
                               heads=layout and layout.attn)
    else:
        out, upd = mamba_mixer(h, lp, cfg, cache=cache)
    if upd:
        cache_out.update(upd)
    cross = mixer == "attn" and "xwq" in lp
    if par is None:
        x = x + out
    else:
        x = par.residual(x, out, layout.attn is not None, last and not cross and ffn == "none")
    if cross:  # whisper cross-attention sublayer
        h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        out, upd = _attn_block(h, lp, cfg, positions, kv_in=enc_out,
                               cache=cache, cross=True, par=par,
                               heads=layout and layout.xattn)
        if upd:
            cache_out.update(upd)
        if par is None:
            x = x + out
        else:
            x = par.residual(x, out, layout.xattn is not None, last and ffn == "none")
    if ffn != "none":
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if par is None:
            x = x + _ffn_block(h, lp, cfg, ffn)
        elif layout.ffn:
            y, bias = _ffn_block(h, lp, cfg, ffn, par, split=True)
            x = par.residual(x, y, True, last, bias)
        else:
            x = par.residual(x, _ffn_block(h, lp, cfg, ffn), False, last)
    return x, cache_out


def _checkpointed(fn, x, *args):
    """``fn(x, *args)`` under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of the scan body): activations are recomputed in the
    backward instead of kept."""
    return torch.utils.checkpoint.checkpoint(fn, x, *args, use_reentrant=False)


def _plan(cfg, mesh, dp_axes, rows: int):
    """The ``MeshPlan`` of a forward given this rank's ``rows`` of a batch
    split over every dp axis (None without a mesh)."""
    if mesh is None:
        return None
    from repro_torch.lm.parallel import MeshPlan

    dp = tuple(a for a in dp_axes if a in mesh.axis_names)
    return MeshPlan(cfg, mesh, dp, rows * mesh.ways(dp))


def encode_frames(params, cfg: LMConfig, frames: torch.Tensor, mesh=None,
                  dp_axes=(), par=None) -> torch.Tensor:
    """Whisper encoder over stub conv-frontend embeddings [B, Senc, D] (over
    a ``mesh``, this rank's rows and shards)."""
    par = par or _plan(cfg, mesh, dp_axes, frames.shape[0])
    enc = params["enc"]
    pos = enc["pos_embed"] if par is None else par.weight("enc/pos_embed", enc["pos_embed"],
                                                          stacked=False)
    x = (frames.float() + pos[None, :frames.shape[1]]).to(COMPUTE_DTYPE)
    positions = torch.arange(frames.shape[1], device=frames.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled()

    def body(y, lp):
        return _layer(y, lp, cfg, "attn", "dense", positions, causal=False, par=par,
                      path="enc/layers")[0]

    for r in range(enc["layers"]["ln1"].shape[0]):
        lp = _rep_slice(enc["layers"], r)
        x = _checkpointed(body, x, lp) if remat else body(x, lp)
    norm = enc["final_norm"] if par is None else par.weight(
        "enc/final_norm", enc["final_norm"], stacked=False)
    return rms_norm(x, norm, cfg.norm_eps)


def forward(params, cfg: LMConfig, tokens=None, embeddings=None,
            enc_frames=None, mesh=None, dp_axes=(), caches=None,
            cache_len=None, positions=None, pad_cache_to=None, par=None):
    """Returns (hidden [B,S,D] after the final norm, new_caches or None).

    ``caches``: None (train) | "init" (prefill: build caches) | a tree with
    leaves stacked [n_rep, ...] (decode: consume and produce caches).

    Over a ``mesh``: the inputs are this rank's rows of a batch split over
    every one of ``dp_axes`` (a step's ``par``, a ``parallel.MeshPlan``,
    says otherwise), ``params`` its shards (``sharding.param_specs``),
    ``caches`` its ``cache_spec`` shards (the rank's rows, whole, under
    ``fsdp``); the hidden states are its rows, whole."""
    if embeddings is not None:
        x = embeddings.to(COMPUTE_DTYPE)
        b, s = x.shape[0], x.shape[1]
        dev = x.device
    else:
        b, s = tokens.shape
        dev = tokens.device
    par = par or _plan(cfg, mesh, dp_axes, b)
    if embeddings is None:
        rows = params["embed"][tokens] if par is None else par.embed(params["embed"], tokens)
        x = rows.to(COMPUTE_DTYPE)
    if positions is None:
        base = 0 if cache_len is None else int(cache_len)
        positions = base + torch.arange(s, device=dev)[None, :]
    if cfg.learned_pos:
        table = params["pos_embed"] if par is None else par.weight(
            "pos_embed", params["pos_embed"], stacked=False)
        x = x + table[positions].to(COMPUTE_DTYPE)

    enc_out = None
    if cfg.is_encdec and enc_frames is not None:
        enc_out = encode_frames(params, cfg, enc_frames, mesh, dp_axes, par=par)

    pattern = block_pattern(cfg)
    build = isinstance(caches, str) and caches == "init"
    has_caches = caches is not None and not build
    seq = par is not None and par.seq_split(s)

    def block_body(x, bp, bc):
        new_c = {}
        for pi, (mixer, ffn) in enumerate(pattern):
            c_in = bc[f"pos{pi}"] if has_caches else ({} if build else None)
            x, c_out = _layer(x, bp[f"pos{pi}"], cfg, mixer, ffn, positions,
                              enc_out=enc_out, cache=c_in,
                              cache_len=cache_len, pad_cache_to=pad_cache_to,
                              par=par, path=f"blocks/pos{pi}",
                              last=seq and pi == len(pattern) - 1)
            if c_out is not None:
                new_c[f"pos{pi}"] = c_out
        return x, new_c

    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    reps = n_repeats(cfg)
    outs = []
    for r in range(reps):
        bp = _rep_slice(params["blocks"], r)
        bc = _rep_slice(caches, r) if has_caches else None
        if par is not None and has_caches:
            bc = {p: {k: par.cache_in(k, v) for k, v in c.items()} for p, c in bc.items()}
        if seq and r > 0:
            x = par.gather_seq(x)
        if remat:
            x = _checkpointed(lambda y, p: block_body(y, p, None)[0], x, bp)
        else:
            x, c = block_body(x, bp, bc)
            if par is not None and c:
                c = {p: {k: par.cache_out(v) for k, v in cc.items()} for p, cc in c.items()}
            outs.append(c)
    if seq:
        x = par.gather_seq(x)
    norm = params["final_norm"] if par is None else par.weight(
        "final_norm", params["final_norm"], stacked=False)
    x = rms_norm(x, norm, cfg.norm_eps)
    new_caches = _stack_trees(outs) if (has_caches or build) else None
    return x, new_caches


def logits_fn(params, cfg: LMConfig, hidden: torch.Tensor, par=None) -> torch.Tensor:
    """Logits [..., V padded] (under ``par``, of this rank's rows: a
    vocabulary split over model is computed by blocks and gathered)."""
    if par is not None:
        w, block = par.head_weight(params)
        if block is not None:
            hidden = par.copy_in(hidden)
    else:
        w, block = (params["embed"].T if cfg.tie_embeddings else params["lm_head"]), None
    logits = hidden @ w.to(hidden.dtype)
    vp = cfg.padded_vocab()
    if vp != cfg.vocab_size:  # mask the padded vocab columns
        cols = torch.arange(vp, device=hidden.device)
        if block is not None:
            cols = cols[block[0]:block[0] + block[1]]
        logits = torch.where(cols < cfg.vocab_size, logits, logits.new_tensor(-1e30))
    return logits if block is None else par.gather_vocab(logits)


def chunked_ce_loss(params, cfg: LMConfig, hidden, labels, chunk: int = 512, par=None):
    """Cross-entropy without materializing [B, S, V]: a loop over S-chunks,
    summed in fp32 in chunk order. Under ``par``: this rank's rows' share of
    the mean over the global batch, and where the vocabulary is split over
    model, each chunk's max and sum of exps are reduced over it."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    assert s % chunk == 0
    block = None
    if par is None:
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    else:
        w, block = par.head_weight(params)
    w = w.to(COMPUTE_DTYPE)
    cols = torch.arange(cfg.padded_vocab(), device=hidden.device)
    if block is not None:
        lo, n = block
        cols = cols[lo:lo + n]
        hidden = par.copy_in(hidden)
    vmask = (cols < cfg.vocab_size).float()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // chunk):
        hc = hidden[:, i * chunk:(i + 1) * chunk]
        lc = labels[:, i * chunk:(i + 1) * chunk]
        logits = (hc @ w).float() + (vmask - 1.0) * 1e30
        if block is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.take_along_dim(logits, lc[..., None].long(), dim=-1)[..., 0]
        else:
            # max and sum of exps over the blocks; the max is a constant of
            # logsumexp's gradient
            mx = par.vocab_max(logits.amax(dim=-1))
            logz = mx + torch.log(par.row_sum(torch.exp(logits - mx[..., None]).sum(-1)))
            t = lc.long() - lo
            mine = (t >= 0) & (t < n)
            gold = torch.take_along_dim(logits, t.clamp(0, n - 1)[..., None], dim=-1)[..., 0]
            gold = par.row_sum(torch.where(mine, gold, gold.new_zeros(())))
        total = total + torch.sum(logz - gold)
    return total / (b * s if par is None else par.batch * s)
