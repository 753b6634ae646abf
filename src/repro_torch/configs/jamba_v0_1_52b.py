"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887; hf]. 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 (every other layer, per the released
config); mamba layers use d_state=16, expand=2 as in the HF release."""
from repro_torch.lm.config import LMConfig

CONFIG = LMConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    attn_every=8,          # 1 attention : 7 mamba
    n_experts=16,
    top_k=2,
    moe_mode="ep",         # 16 experts divide the 16-way model axis exactly
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    rope_theta=1_000_000.0,
)
