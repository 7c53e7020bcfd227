"""Minitron-8B — pruned Nemotron dense GQA [arXiv:2407.14679; hf].

(Itself a *pruned* model — the paper's structured-pruning lineage.)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256000, head_dim=128,
    rope_theta=10000.0, attn_shard="heads",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=256, head_dim=16, remat="none")
