"""Training: losses, the overflow-gated Adam step and densification
(counterpart of ``tpusplat/train``)."""
