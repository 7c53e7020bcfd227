"""Mixtral-8x7B — MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128,
    n_experts=8, top_k=2, sliding_window=4096,
    rope_theta=1e6, supports_long=True,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=256, head_dim=16, n_experts=4,
                       top_k=2, sliding_window=32, remat="none")
