"""Architecture config schema + registry (the port's own copy of
``repro.configs.base``: the port never imports the JAX package).

One module per ported architecture lives next to this file; each exposes
``CONFIG`` (the exact published shape) and ``SMOKE`` (a reduced same-family
config for CPU tests).  ``get(name)`` resolves either.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_group: int = 1024       # tokens per dispatch group
    # SSM (mamba2 mixers: the ssm family, and hybrid's parallel heads)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    sliding_window: int = 0
    rope_theta: float = 10000.0
    cross_attn_interval: int = 0   # vlm: one cross-attn layer per this many
    n_enc_layers: int = 0          # encdec encoder depth
    n_frontend_tokens: int = 1024  # audio/vlm stub embedding count
    kv_chunk: int = 1024        # KV chunk of the online-softmax attention
    # distribution (``distributed.sharding``)
    attn_shard: str = "heads"   # "heads" | "seq" (when n_heads % tp != 0)
    train_shard_mode: str = "fsdp"  # "fsdp" (ZeRO-3 weights, tokens over
    #   every axis) | "tp" (Megatron); serving always runs "tp"
    # training
    optimizer: str = "adamw"    # "adamw" | "adafactor" (>= 70B)
    remat: str = "full"         # "none" | "full" (checkpoint every layer)
    supports_long: bool = False  # sub-quadratic 500k decode legal
    unroll_layers: bool = False  # the reference's python-loop layer stacks
    #   for its cost probes (XLA counts a scan body once); the port always
    #   loops over its layers in Python (``models.transformer``), so the
    #   flag changes nothing here: ``launch.dryrun._probe_cfgs`` sets it as
    #   the reference's does

    @property
    def hd(self):
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


ARCH_IDS = [
    "seamless_m4t_large_v2", "yi_9b", "granite_8b", "minitron_8b",
    "phi3_medium_14b", "mamba2_1p3b", "mixtral_8x7b", "kimi_k2_1t_a32b",
    "hymba_1p5b", "llama_3p2_vision_90b",
]

# canonical external ids -> module names
ALIASES = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "yi-9b": "yi_9b",
    "granite-8b": "granite_8b",
    "minitron-8b": "minitron_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "mamba2-1.3b": "mamba2_1p3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "hymba-1.5b": "hymba_1p5b",
    "llama-3.2-vision-90b": "llama_3p2_vision_90b",
}


def get(name: str, smoke: bool = False) -> ArchConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if mod_name not in ALIASES.values():
        raise KeyError(f"architecture {name!r} is not ported yet "
                       f"(ported: {sorted(ALIASES)})")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.CONFIG


SHAPES = {
    # shape id: (seq_len, global_batch, step kind)
    "train_4k":    dict(seq=4096,   batch=256, kind="train"),
    "prefill_32k": dict(seq=32768,  batch=32,  kind="prefill"),
    "decode_32k":  dict(seq=32768,  batch=128, kind="decode"),
    "long_500k":   dict(seq=524288, batch=1,   kind="decode"),
}
