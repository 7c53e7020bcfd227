"""PyTorch + CUDA port of ``repro`` (the JAX/Pallas reference package).

Module names mirror ``repro``'s so each counterpart is easy to find.  The
port imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``.  Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU, where every kernel wrapper runs its plain PyTorch
version instead.
"""
