"""Attention, normalization and pixel ops; the CUDA kernels' wrappers live here."""
