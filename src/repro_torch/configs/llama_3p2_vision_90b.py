"""Llama-3.2-Vision-90B — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision scaled; unverified].

100 layers = 20 groups of (4 self-attn + 1 gated cross-attn); the vision
tower is a stub: callers pass patch embeddings (B, n_patches, d_model) as
``frontend``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    cross_attn_interval=5, n_frontend_tokens=1024,
    rope_theta=5e5, optimizer="adafactor",
)

SMOKE = CONFIG.replace(n_layers=10, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=256, head_dim=16,
                       cross_attn_interval=5, n_frontend_tokens=16,
                       remat="none")
