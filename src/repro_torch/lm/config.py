"""Config system for the LM architecture zoo: the JAX package's
``lm/config.py``, which is framework-free, carried over unchanged in its
fields and properties."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int            # query heads; 0 for attention-free archs
    n_kv_heads: int
    d_ff: int               # dense MLP width (per expert for MoE)
    vocab_size: int
    head_dim: int = 0       # 0 -> d_model // n_heads
    # attention
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0           # 0 = full attention
    rope_theta: float = 1_000_000.0
    learned_pos: int = 0              # >0: learned positional table (whisper)
    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_mode: str = "tp"              # tp = F-sharded experts | ep = expert-parallel
    # layer pattern
    attn_every: int = 1               # hybrid: layer i is attention iff i % attn_every == 0
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0                # N; 0 = no ssm layers
    ssm_head_dim: int = 64            # P
    ssm_expand: int = 2
    ssm_chunk: int = 256              # SSD chunk length
    ssm_conv: int = 4                 # causal conv width
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0              # 1500 frames for whisper
    # modality frontend (stub): input_specs returns precomputed embeddings
    frontend: str = "none"            # none | audio | vision
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    remat: bool = True
    # families: dense | moe | ssm | hybrid | audio | vlm
    family: str = "dense"
    # Dry-run fields, kept for the reference's configs: ``exact_cost_mode``
    # unrolls the reference's scans for its cost analysis (the port's block
    # loop is eager, so its only effect here is ``attention``'s
    # "dense_chunked" mode); ``seq_shard`` shards the residual stream's
    # sequence dim over the model axis between repetitions, under a mesh's
    # 2d profile (``lm/parallel.py``).
    exact_cost_mode: bool = False
    seq_shard: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:  # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_hybrid(self) -> bool:
        return self.ssm_state > 0 and self.n_heads > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.ssm_state > 0 and self.n_heads == 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k? (SSM / hybrid / sliding-window)."""
        return self.ssm_state > 0 or self.sliding_window > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind."""
        if self.is_ssm_only:
            return tuple("ssm" for _ in range(self.n_layers))
        if self.is_hybrid:
            return tuple(
                "attn" if i % self.attn_every == 0 else "ssm"
                for i in range(self.n_layers)
            )
        return tuple("attn" for _ in range(self.n_layers))

    def padded_vocab(self, multiple: int = 256) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for roofline 6ND."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.padded_vocab() * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds():
            if kind == "attn":
                n += d * (self.n_heads * hd) * 2            # wq, wo
                n += d * (self.n_kv_heads * hd) * 2         # wk, wv
            else:
                din = self.d_inner
                conv_dim = din + 2 * self.ssm_state
                n += d * (2 * din + 2 * self.ssm_state + self.ssm_heads)  # in_proj
                n += din * d                                 # out_proj
                n += self.ssm_conv * conv_dim + 3 * self.ssm_heads
            if self.is_moe:
                n += d * self.n_experts                      # router
                n += self.n_experts * 3 * d * self.d_ff
            elif self.d_ff:
                n += 3 * d * self.d_ff
            n += 2 * d                                       # norms
        if self.is_encdec:
            # encoder layers: self-attn + mlp (approx; same shapes as decoder)
            per = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2 + 3 * d * self.d_ff
            n += self.encoder_layers * per
            n += self.n_layers * (d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2)  # cross-attn
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        moe_total = self.n_layers * self.n_experts * 3 * self.d_model * self.d_ff
        moe_active = self.n_layers * self.top_k * 3 * self.d_model * self.d_ff
        return full - moe_total + moe_active
