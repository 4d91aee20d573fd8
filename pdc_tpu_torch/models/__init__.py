"""Backbones, the DenseCorrespondenceNetwork wrapper and the weight bridge
to the JAX package's checkpoints."""
