"""Streams of randomness derived from a run's ``--seed`` (any non-negative
whole number, larger than 32 bits included): one independent stream per
purpose, so that adding a stream moves no other."""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose``, from ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def numpy_rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, purpose))


def torch_generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, purpose))
