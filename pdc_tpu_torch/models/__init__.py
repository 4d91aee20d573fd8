"""Backbones, the DenseCorrespondenceNetwork wrapper, the weight and
optimizer-state bridge to the JAX package's checkpoints, and ImageNet
initialisation from torchvision weights."""
