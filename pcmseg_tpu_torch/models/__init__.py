from pcmseg_tpu_torch.models.nnunet import PlainConvUNet
from pcmseg_tpu_torch.models.unet3d import UNet3D

MODELS = {"unet3d": UNet3D, "nnunet": PlainConvUNet}


def build_model(config, **kwargs):
    """The network ``config.model`` names, built by its ``from_config``
    (``kwargs`` such as ``deep_supervision``, ``generator``, ``device``)."""
    return MODELS[config.model].from_config(config, **kwargs)
