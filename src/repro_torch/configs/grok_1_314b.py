"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified].
64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072."""
from repro_torch.lm.config import LMConfig

CONFIG = LMConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    n_experts=8,
    top_k=2,
    moe_mode="tp",   # 8 experts don't divide the 16-way model axis -> F-sharded
)
