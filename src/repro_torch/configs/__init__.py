from repro_torch.configs.base import ALIASES, ArchConfig, get

__all__ = ["ALIASES", "ArchConfig", "get"]
