"""minsdtf-tpu ported to PyTorch and CUDA for an NVIDIA H100 (Hopper).

Imports torch and numpy only: nothing of JAX or of the ``minsdtf_tpu`` package.
"""

from minsdtf_tpu_torch.pipeline import StableDiffusion

__all__ = ["StableDiffusion"]
