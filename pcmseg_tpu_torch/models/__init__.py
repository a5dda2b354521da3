from pcmseg_tpu_torch.models.unet3d import UNet3D  # noqa: F401
