"""GQA attention with RoPE / qk-norm / QKV-bias / sliding-window, in the JAX
package's execution modes (``lm/attention.py``):

  * ``blockwise``     — flash-style: a loop over KV blocks with an online
                        softmax; never materializes [S, S].
  * ``dense``         — the reference path for short sequences and tests.
  * ``dense_chunked`` — a q-chunk loop with static causal/window K slicing.
  * ``decode``        — one query step against a KV cache.

Plain tensor code that follows the reference's arithmetic: products in the
inputs' dtype (bf16 in the model), logits and the softmax in fp32, and the
probabilities rounded to the inputs' dtype before the value product.
``scaled_dot_product_attention`` is not used: parity is held to the
reference's own modes. Shapes follow [B, S, H, hd]; GQA repeats KV heads by
grouping (dense, decode) or by expansion (blockwise).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def dense_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Reference attention. q [B,Sq,H,hd], k/v [B,Sk,KV,hd]; GQA in grouped
    form (no KV head repetition is materialized)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    n_rep = h // kv
    qg = q.reshape(b, sq, kv, n_rep, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float() * scale
    sk = k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None, None], logits, logits.new_tensor(NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", probs, v).reshape(b, sq, h, hd)


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        q_chunk: int = 1024, kv_chunk: int = 1024) -> torch.Tensor:
    """Flash-style attention: O(S·chunk) working set via an online softmax
    over KV blocks. Non-divisible lengths are zero-padded; padded keys are
    masked out and padded queries sliced off."""
    b, sq_orig, h, hd = q.shape
    sk_orig = k.shape[1]
    q_chunk = min(q_chunk, sq_orig)
    kv_chunk = min(kv_chunk, sk_orig)
    if sq_orig % q_chunk:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, (-sq_orig) % q_chunk))
    if sk_orig % kv_chunk:
        pad = (0, 0, 0, 0, 0, (-sk_orig) % kv_chunk)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    sq, sk = q.shape[1], k.shape[1]
    n_rep = h // k.shape[2]
    nq, nk = sq // q_chunk, sk // kv_chunk
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    k = k.reshape(b, nk, kv_chunk, k.shape[2], hd)
    v = v.reshape(b, nk, kv_chunk, v.shape[2], hd)

    def q_block(qi, q_blk):
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, q_chunk, h, hd), dtype=torch.float32, device=dev)
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        # Only the blocks that meet the causal frontier.
        nk_q = (((qi + 1) * q_chunk + kv_chunk - 1) // kv_chunk) if causal else nk
        for ki in range(nk_q):
            kb = _repeat_kv(k[:, ki], n_rep)            # [b, kc, h, hd]
            vb = _repeat_kv(v[:, ki], n_rep)
            logits = torch.einsum("bqhd,bkhd->bhqk", q_blk, kb).float() * scale
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = (kpos[None, :] < sk_orig).expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window > 0:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            logits = torch.where(mask[None, None], logits, logits.new_tensor(NEG_INF))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr.permute(0, 2, 1)[..., None] + torch.einsum(
                "bhqk,bkhd->bqhd", p, vb.float())
            m = m_new
        return acc / torch.clamp(l, min=1e-30).permute(0, 2, 1)[..., None]

    outs = [q_block(qi, q[:, qi * q_chunk:(qi + 1) * q_chunk]) for qi in range(nq)]
    return torch.cat(outs, dim=1)[:, :sq_orig].to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0) -> torch.Tensor:
    """One-token attention. q [B,1,H,hd]; caches [B,S,KV,hd]; cache_len [B].
    Grouped GQA form: the KV cache is read once, never repeated."""
    b, sq, h, hd = q.shape
    kv = k_cache.shape[2]
    n_rep = h // kv
    qg = q.reshape(b, sq, kv, n_rep, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_cache).float() * scale
    s = k_cache.shape[1]
    kpos = torch.arange(s, device=q.device)[None, :]
    cache_len = torch.as_tensor(cache_len, device=q.device)
    mask = kpos < cache_len[:, None]
    if window > 0:
        mask &= kpos >= (cache_len[:, None] - window)
    logits = torch.where(mask[:, None, None, None, :], logits, logits.new_tensor(NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v_cache)
    return out.reshape(b, sq, h, hd)


def dense_chunked_attention(q, k, v, *, causal=True, window=0, q_chunk=1024):
    """A q-chunk loop with STATIC causal/window K slicing: the semantics of
    ``blockwise_attention``, skipping the all-masked upper triangle."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    q_chunk = min(q_chunk, sq)
    outs = []
    nq = (sq + q_chunk - 1) // q_chunk
    for qi in range(nq):
        lo_q = qi * q_chunk
        hi_q = min(lo_q + q_chunk, sq)
        hi = min(hi_q, sk) if causal else sk
        lo = max(0, lo_q + 1 - window) if window else 0
        lo = (lo // 128) * 128  # the reference's lane-aligned slices
        outs.append(dense_attention(q[:, lo_q:hi_q], k[:, lo:hi], v[:, lo:hi],
                                    causal=causal, window=window, q_offset=lo_q - lo))
    return torch.cat(outs, dim=1)


def attention(q, k, v, *, causal=True, window=0, mode="auto", q_offset=0):
    if mode == "auto":
        mode = "blockwise" if q.shape[1] * k.shape[1] > 4_194_304 else "dense"
    if mode == "dense":
        return dense_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if mode == "dense_chunked":
        return dense_chunked_attention(q, k, v, causal=causal, window=window)
    return blockwise_attention(q, k, v, causal=causal, window=window)
