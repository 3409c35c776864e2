"""PyTorch/CUDA port of synfmc_tpu for one NVIDIA Hopper GPU.

Mirrors the JAX package's layout (ops/, models/, diffusion/, pipelines/,
geometry/, data/, interop/, training/, serving/, evaluation/, utils/, and the
entry points under scripts/).  Video tensors keep the JAX layout
``(B, F, H, W, C)`` at every public function; the three Pallas kernels of the
serving path (packed flash attention, packed temporal attention, fused
GroupNorm) are hand-written CUDA kernels under ``csrc/``, built with ``nvcc``
at first use.  Nothing here imports jax, flax or synfmc_tpu, nor the
third-party readers the JAX package uses (transformers, safetensors, imageio,
PIL): the checkpoint, tokenizer and GIF code is this package's own.
"""

__version__ = "0.1.0"
