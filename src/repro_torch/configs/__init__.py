"""Config registry + ``input_specs``: shape / dtype stand-ins (meta
tensors) for every model input of every (arch x shape) cell, with no
allocation (the dry run's pattern; the reference's
``repro.configs``)."""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ALIASES, ARCH_IDS, SHAPES, ArchConfig, get

__all__ = ["ArchConfig", "SHAPES", "ARCH_IDS", "ALIASES", "get",
           "input_specs", "cell_is_supported"]


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def cell_is_supported(cfg: ArchConfig, shape_id: str) -> tuple[bool, str]:
    """long_500k requires sub-quadratic attention (DESIGN.md §3)."""
    if shape_id == "long_500k" and not cfg.supports_long:
        return False, ("SKIP: pure full-attention arch — 500k dense-KV decode "
                       "is quadratic with no SWA/SSM escape (DESIGN.md)")
    return True, ""


@functools.lru_cache(maxsize=None)
def _abstract_cache_spec(cfg: ArchConfig, batch: int, seq: int):
    from repro_torch.models import transformer as T
    return T.init_cache(T.init_lm(cfg, device="meta"), cfg, batch, seq)


def input_specs(cfg: ArchConfig, shape_id: str, smoke: bool = False,
                batch: int | None = None) -> dict:
    """Returns {name: meta tensor} for the given step kind.

    train:   tokens/labels (B, S) int32 (+ frontend embeds for encdec/vlm)
    prefill: tokens (B, S) int32 (+ frontend)
    decode:  token/pos (B, 1) int32 + the full KV/SSM cache tree

    ``batch`` cuts the shape's global batch (the one-card checks of
    ``chip_smoke.py``); None keeps it.
    """
    sh = SHAPES[shape_id]
    B, S, kind = batch or sh["batch"], sh["seq"], sh["kind"]
    specs = {}
    if kind in ("train", "prefill"):
        specs["tokens"] = _sds((B, S), torch.int32)
        if kind == "train":
            specs["labels"] = _sds((B, S), torch.int32)
    else:  # decode: one new token over a seq_len cache
        specs["token"] = _sds((B, 1), torch.int32)
        specs["pos"] = _sds((B, 1), torch.int32)
        specs["cache"] = _abstract_cache_spec(cfg, B, S)
    if cfg.family in ("encdec", "vlm") and kind != "decode":
        specs["frontend"] = _sds((B, cfg.n_frontend_tokens, cfg.d_model),
                                 torch.bfloat16)
    return specs
