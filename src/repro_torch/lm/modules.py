"""Shared neural building blocks, as the JAX package's ``lm/modules.py``
computes them: in the input's dtype where the reference is, in fp32 where it
upcasts."""
from __future__ import annotations

import math

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32, scaled by the (fp32) ``scale``, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)
    return (x * scale).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, hd]; positions [..., S] (broadcastable). Rotated in fp32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)                 # [hd/2]
    angles = positions[..., None].float() * freqs                   # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                           # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · sigmoid(x), with the sigmoid as the reference's
    ``1 / (1 + exp(-x))``, each step rounded in x's dtype (bitwise the JAX
    package's bf16 result on the CPU)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh approximation), in x's dtype: its
    constants are x's dtype too, as JAX's weak types make them."""
    c = x.new_tensor(math.sqrt(2 / math.pi))
    k = x.new_tensor(0.044715)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x ** 3))))
    return x * cdf


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x@gate) * (x@up) )."""
    return (silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_up, b_up, w_down, b_down) -> torch.Tensor:
    return gelu(x @ w_up + b_up) @ w_down + b_down


def init_dense(generator, shape, in_axis: int = -2) -> torch.Tensor:
    """N(0, 1/fan_in) in fp32, drawn from ``generator`` on its device; a
    ``torch.device("meta")`` in its place gives the shape alone."""
    fan_in = shape[in_axis]
    if isinstance(generator, torch.device):
        return torch.empty(tuple(shape), dtype=torch.float32, device=generator)
    # In place: no second tensor of the shape (an MoE layer's expert weights
    # are GBs at full width).
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                       device=generator.device).div_(math.sqrt(fan_in))
