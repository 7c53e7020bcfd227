"""Phi-3-medium-14B — RoPE SwiGLU GQA [arXiv:2404.14219; unverified].

SMOKE keeps the published head shape's awkwardness: d_model 60 and
head_dim 12, which (16, 16) blocks do not tile (take a block from
``core.regularity.legal_blocks``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab=100352, head_dim=128,
    rope_theta=10000.0, attn_shard="seq",
    train_shard_mode="tp",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=60, n_heads=5, n_kv_heads=5,
                       d_ff=128, vocab=256, head_dim=12, remat="none")
