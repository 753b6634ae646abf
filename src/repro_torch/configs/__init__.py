"""Architecture registry: one module per assigned architecture (``--arch``)."""
from __future__ import annotations

from typing import Dict

from repro_torch.lm.config import LMConfig

from repro_torch.configs.jamba_v0_1_52b import CONFIG as jamba_v0_1_52b
from repro_torch.configs.qwen2_72b import CONFIG as qwen2_72b
from repro_torch.configs.qwen3_4b import CONFIG as qwen3_4b
from repro_torch.configs.qwen2_0_5b import CONFIG as qwen2_0_5b
from repro_torch.configs.internlm2_20b import CONFIG as internlm2_20b
from repro_torch.configs.whisper_large_v3 import CONFIG as whisper_large_v3
from repro_torch.configs.llava_next_34b import CONFIG as llava_next_34b
from repro_torch.configs.grok_1_314b import CONFIG as grok_1_314b
from repro_torch.configs.mixtral_8x22b import CONFIG as mixtral_8x22b
from repro_torch.configs.mamba2_1_3b import CONFIG as mamba2_1_3b

ARCHS: Dict[str, LMConfig] = {
    c.name: c
    for c in [
        jamba_v0_1_52b,
        qwen2_72b,
        qwen3_4b,
        qwen2_0_5b,
        internlm2_20b,
        whisper_large_v3,
        llava_next_34b,
        grok_1_314b,
        mixtral_8x22b,
        mamba2_1_3b,
    ]
}


def get_arch(name: str) -> LMConfig:
    return ARCHS[name]


def reduced_config(cfg: LMConfig) -> LMConfig:
    """Same-family tiny config for CPU smoke tests (per assignment: small
    layers/width, few experts, tiny vocab)."""
    import dataclasses

    pattern = max(cfg.attn_every, 1)
    if cfg.is_hybrid:
        n_layers = pattern * 1  # one full hybrid block
    elif cfg.is_moe:
        n_layers = 2
    else:
        n_layers = 2
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=64,
        n_heads=max(4, 0) if cfg.n_heads else 0,
        n_kv_heads=2 if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        n_experts=4 if cfg.is_moe else 0,
        top_k=2 if cfg.is_moe else 2,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        encoder_layers=1 if cfg.encoder_layers else 0,
        encoder_seq=12 if cfg.encoder_seq else 0,
        learned_pos=64 if cfg.learned_pos else 0,
        sliding_window=16 if cfg.sliding_window else 0,
        remat=False,
    )
