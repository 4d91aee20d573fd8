"""Descriptor-space ops and the CUDA kernels behind them."""
