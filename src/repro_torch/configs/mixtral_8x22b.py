"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]. 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, window 4096 (per the assignment's SWA designation)."""
from repro_torch.lm.config import LMConfig

CONFIG = LMConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    n_experts=8,
    top_k=2,
    moe_mode="tp",
    sliding_window=4096,
)
