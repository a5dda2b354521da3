"""pcmseg_tpu_torch — the PyTorch / CUDA port of pcmseg_tpu for NVIDIA Hopper.

This first slice is the folded-BN serving path: ``.pth`` checkpoint →
BN folding → 4-level U-Net whose 3³ convs run through a hand-written
``sm_90a`` CUDA kernel → sigmoid → threshold on the device → uint8 NIfTI
mask, behind ``python -m pcmseg_tpu_torch {predict,serve}``. The JAX
package ``pcmseg_tpu`` stays the reference; this package imports only its
jax-free host modules (config, NIfTI/MHA I/O, resampling, logging).
"""

__version__ = "0.1.0"
