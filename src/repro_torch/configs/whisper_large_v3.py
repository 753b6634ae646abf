"""whisper-large-v3 [audio] — enc-dec backbone; conv frontend is a STUB per
the assignment (input_specs supplies precomputed frame embeddings)
[arXiv:2212.04356; unverified]. 32L d_model=1280 20H (kv=20, i.e. MHA)
d_ff=5120 vocab=51866; learned positions; 1500 encoder frames."""
from repro_torch.lm.config import LMConfig

CONFIG = LMConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    learned_pos=32_768,      # decoder positional table sized to the largest
                             # applicable cell (long_500k is skipped: full attn)
    encoder_layers=32,
    encoder_seq=1500,
    frontend="audio",
)
