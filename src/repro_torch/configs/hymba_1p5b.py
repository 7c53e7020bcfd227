"""Hymba-1.5B — hybrid parallel attention + mamba heads [arXiv:2411.13676;
hf].

SSM branch: d_inner=3200, headdim=100 -> 32 SSD heads, state=16.
Sliding-window attention (1024) beside the SSM state; a SwiGLU FFN after
both."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    ssm_state=16, ssm_headdim=100, ssm_expand=2,
    sliding_window=1024, attn_shard="seq",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=256, head_dim=16, ssm_state=8,
                       ssm_headdim=16, sliding_window=32, remat="none",
                       attn_shard="heads")
