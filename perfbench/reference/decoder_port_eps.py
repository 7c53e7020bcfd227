"""``decoder`` at the port's RMSNorm epsilon.

The port adds 1e-6 to every norm's mean square whatever the model states
(``repro_torch.models.layers.rmsnorm``, as the JAX package it was ported
from; its ``ArchConfig`` has no epsilon).  A model that publishes another
epsilon (Mixtral-8x7B: 1e-5) is compared at the port's, a departure its
configuration file states, as it states the decode window and the expert
capacity that ``decoder`` follows.  At embedding-scale activations
(N(0, 0.02)) the two epsilons move the first layer's normed input by ~1 %,
far more than bf16 rounding does."""
from perfbench.reference import decoder

PORT_EPS = 1e-6


def logits(params, m, seqs):
    """``decoder.logits`` with ``rms_norm_eps`` at the port's."""
    return decoder.logits(params, dict(m, rms_norm_eps=PORT_EPS), seqs)
