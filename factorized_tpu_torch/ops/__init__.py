"""Primitives, LSTMs, block-diagonal fusion and the CUDA kernels' wrappers."""
