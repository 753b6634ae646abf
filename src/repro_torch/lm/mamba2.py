"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) mixer, as the JAX
package's ``lm/mamba2.py`` computes it.

Training/prefill use the chunked SSD algorithm as a loop over chunks:
quadratic attention-like compute *within* a chunk, the linear state
recurrence *across* chunks (carry [B,H,P,N] in fp32). Decode is the O(1)
recurrent update. Where the reference multiplies a bf16 operand by an fp32
one, it promotes the bf16 operand exactly; the port casts it so.

Shapes: x [B,T,H,P]; dtA [B,T,H] (negative); Bm/Cm [B,T,G,N]; heads H map to
groups G by contiguous blocks (rep = H // G).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.lm.modules import rms_norm, silu


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., Q] -> L [..., Q, Q] with L[i,j] = sum_{j<k<=i} a[k], -inf above
    the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, d, d.new_tensor(float("-inf")))


def _rep(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    return torch.repeat_interleave(t, rep, dim=dim) if rep != 1 else t


def ssd_scan(x, dtA, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD. Returns (y [B,T,H,P] in x's dtype, final_state
    [B,H,P,N] fp32)."""
    b, t, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    assert t % chunk == 0, (t, chunk)
    c = t // chunk
    xc = x.reshape(b, c, chunk, h, p)
    ac = dtA.reshape(b, c, chunk, h)
    bc = Bm.reshape(b, c, chunk, g, n)
    cc = Cm.reshape(b, c, chunk, g, n)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state)
    ys = []
    for i in range(c):
        x_c, a_c, b_c, c_c = xc[:, i], ac[:, i], bc[:, i], cc[:, i]
        a_cs = torch.cumsum(a_c, dim=1)                               # [b,q,h]
        L = torch.exp(segsum(a_c.permute(0, 2, 1)))                   # [b,h,q,q]
        # intra-chunk (attention-like) term, grouped heads
        scores = torch.einsum("bqgn,bsgn->bgqs", c_c, b_c)           # [b,g,q,s]
        scores = _rep(scores, rep, 1)                                 # [b,h,q,s]
        y_diag = torch.einsum("bhqs,bshp->bqhp", scores.float() * L, x_c.float())
        # inter-chunk: contribution of the incoming state
        state_decay = torch.exp(a_cs)                                 # [b,q,h]
        c_h = _rep(c_c, rep, 2).float()                               # [b,q,h,n]
        y_off = torch.einsum("bqhn,bhpn,bqh->bqhp", c_h, state, state_decay)
        # chunk state to carry forward
        decay_states = torch.exp(a_cs[:, -1:, :] - a_cs)              # [b,q,h]
        b_h = _rep(b_c, rep, 2).float()
        chunk_state = torch.einsum("bqhn,bqh,bqhp->bhpn", b_h, decay_states, x_c.float())
        state = state * torch.exp(a_cs[:, -1, :])[..., None, None] + chunk_state
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.stack(ys, dim=1).reshape(b, t, h, p), state


def ssd_decode_step(state, x, dtA, Bm, Cm):
    """O(1) recurrence. x [B,H,P]; dtA [B,H]; Bm/Cm [B,G,N]; state [B,H,P,N]."""
    h, g = x.shape[1], Bm.shape[1]
    rep = h // g
    b_h = _rep(Bm, rep, 1)                                            # [B,H,N]
    c_h = _rep(Cm, rep, 1)
    decay = torch.exp(dtA)[..., None, None]                           # [B,H,1,1]
    new_state = state * decay + torch.einsum("bhn,bhp->bhpn", b_h, x).float()
    y = torch.einsum("bhn,bhpn->bhp", c_h.float(), new_state)
    return y.to(x.dtype), new_state


def causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width K. x [B,T,C]; w [K,C]; optional incoming
    state [B,K-1,C]. Returns (y, new_state); the taps sum in x's dtype in
    the reference's order."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state, x], dim=1)
    t = x.shape[1]
    y = 0
    for i in range(k):
        y = y + xp[:, i:i + t, :] * w[i]
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return y + b, new_state


def mamba_mixer(h, lp, cfg, cache: Optional[dict] = None):
    """Full Mamba2 block given pre-normed input h [B,T,D] and layer params
    lp. Returns (out [B,T,D], new_cache)."""
    B_, T, D = h.shape
    din = cfg.d_inner
    g, n = 1, cfg.ssm_state
    nh, p = cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = h @ lp["in_proj"].to(h.dtype)                           # [B,T,2din+2gn+nh]
    z, xin, Bm, Cm, dt = torch.split(zxbcdt, [din, din, g * n, g * n, nh], dim=-1)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_state = cache.get("conv") if cache is not None else None
    conv_out, new_conv = causal_conv(conv_in, lp["conv_w"].to(h.dtype),
                                     lp["conv_b"].to(h.dtype), conv_state)
    conv_out = silu(conv_out)
    xin, Bm, Cm = torch.split(conv_out, [din, g * n, g * n], dim=-1)
    dt = F.softplus(dt.float() + lp["dt_bias"])                      # [B,T,nh]
    A = -torch.exp(lp["A_log"].float())                               # [nh]
    dtA = dt * A                                                      # [B,T,nh]
    xh = xin.reshape(B_, T, nh, p)
    x_dt = xh * dt[..., None].to(xh.dtype)
    Bm = Bm.reshape(B_, T, g, n)
    Cm = Cm.reshape(B_, T, g, n)
    if T == 1 and cache is not None:  # decode
        y, new_state = ssd_decode_step(cache["ssm"], x_dt[:, 0], dtA[:, 0], Bm[:, 0], Cm[:, 0])
        y = y[:, None]
    else:
        chunk = min(cfg.ssm_chunk, T)
        init = cache.get("ssm") if cache is not None else None
        pad = (-T) % chunk
        if pad:  # zero padding (dtA = 0, x = 0) leaves state and outputs as they are
            y, new_state = ssd_scan(F.pad(x_dt, (0, 0, 0, 0, 0, pad)),
                                    F.pad(dtA, (0, 0, 0, pad)),
                                    F.pad(Bm, (0, 0, 0, 0, 0, pad)),
                                    F.pad(Cm, (0, 0, 0, 0, 0, pad)), chunk, init_state=init)
            y = y[:, :T]
        else:
            y, new_state = ssd_scan(x_dt, dtA, Bm, Cm, chunk, init_state=init)
    y = y + lp["D_skip"].to(h.dtype)[None, None, :, None] * xh
    y = y.reshape(B_, T, din) * silu(z)
    # grouped RMSNorm before the out-projection (mamba2's norm placement)
    y = rms_norm(y, lp["ssm_norm"], cfg.norm_eps)
    out = y @ lp["out_proj"].to(h.dtype)
    new_cache = {"conv": new_conv, "ssm": new_state} if cache is not None else None
    return out, new_cache
