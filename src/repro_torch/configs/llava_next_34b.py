"""llava-next-34b [vlm] — anyres tiling frontend is a STUB per the assignment
(input_specs supplies pre-fused patch+text embeddings)
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 (Yi-34B backbone)."""
from repro_torch.lm.config import LMConfig

CONFIG = LMConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    frontend="vision",
    rope_theta=5_000_000.0,
)
