"""pcmseg_tpu_torch — the PyTorch / CUDA port of pcmseg_tpu for NVIDIA Hopper.

Serving (``.pth`` checkpoint → BN folding → 4-level U-Net → sigmoid →
threshold on the device → uint8 NIfTI mask) and training of the flagship
configuration, behind ``python -m pcmseg_tpu_torch {train,predict,serve}``,
with every 3³ conv in hand-written ``sm_90a`` CUDA kernels. The JAX package
``pcmseg_tpu`` stays the reference; this package imports nothing of it and
keeps its own copies of the host layer (config, NIfTI/MHA I/O, resampling,
augmentation, logging, the CLI flags).
"""

__version__ = "0.1.0"
