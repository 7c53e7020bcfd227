"""SeamlessM4T-large-v2 — encoder-decoder, multimodal (audio)
[arXiv:2308.11596; hf].  24 encoder + 24 decoder layers, d=1024, 16H MHA
(GQA kv=16), d_ff=8192, vocab=256206.  The speech frontend is a stub:
callers pass precomputed frame embeddings (B, n_frames, d_model) as
``frontend``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    n_frontend_tokens=1024,
)

SMOKE = CONFIG.replace(n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
                       n_frontend_tokens=32, remat="none")
