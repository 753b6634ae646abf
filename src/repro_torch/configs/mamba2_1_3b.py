"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060;
unverified]. 48L d_model=2048, attention-free, d_ff=0, vocab=50280,
ssm_state=128, head_dim=64, expand=2."""
from repro_torch.lm.config import LMConfig

CONFIG = LMConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
)
