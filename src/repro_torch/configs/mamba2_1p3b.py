"""Mamba2-1.3B — SSD state-space duality, attention-free [arXiv:2405.21060].

48 blocks of pure mamba2 mixers (d_ff=0, no attention).  d_inner=4096,
headdim=64 -> 64 SSD heads, state=128.  Block-based pruning covers the
in/out projections; the conv1d and the SSD parameters are never pruned
(paper §5.2.4)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, ssm_state=128, ssm_headdim=64, ssm_expand=2,
    supports_long=True,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, vocab=256, ssm_state=16,
                       ssm_headdim=16, remat="none")
