"""Kimi K2 1T-A32B — trillion-param MoE, 384 experts top-8 (paper-table)
[arXiv:2501.kimi2; unverified].  d_ff=2048 per expert (fine-grained
MoE); dispatch groups of 256 tokens."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, head_dim=112,
    n_experts=384, top_k=8,
    rope_theta=5e6, moe_group=256, optimizer="adafactor",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=64, vocab=256, head_dim=16, n_experts=8,
                       top_k=2, moe_group=64, remat="none")
