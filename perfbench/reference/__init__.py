"""Plain references that decide ``correct``: plain PyTorch in float32 with
TF32 off, importing nothing of the program (``repro_torch``) or of the
JAX package."""
