"""Predictor: one case directory → uint8 NIfTI segmentation, on the GPU.

The port of ``pcmseg_tpu/infer/predict.py`` for one ``.pth`` checkpoint:

  * host ingest: one subdirectory per modality, each holding one volume;
    missing modalities are zero-filled, duplicated from the reference
    modality, or refused (``skip``); every modality is normalized as in
    training and stacked (D, H, W, C);
  * one H2D copy per case from pinned host memory, in bf16 when the net
    computes in bf16 (it casts at its first layer, so rounding on the host
    changes nothing);
  * BN folded into the convs (``config.fold_bn``), so all 18 3³ convs run
    the CUDA kernel with bias and ReLU fused;
  * whole-volume inference when the image fits one window, on-device
    overlap tiling otherwise;
  * sigmoid, threshold on the device, one uint8 D2H copy, atomic write.

Options of the JAX Predictor that this package has not ported raise
``NotImplementedError`` at construction. ``pallas_inference`` is a TPU
switch and is ignored: on CUDA the hand-written kernel is the only conv.
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pcmseg_tpu.core.config import Config, DEFAULT_MODALITIES
from pcmseg_tpu.data.io import ALL_EXTS, read_volume, write_volume
from pcmseg_tpu.data.native import native_normalize_into
from pcmseg_tpu.data.resample import normalize_intensity, resample_array
from pcmseg_tpu.data.volume import Volume
from pcmseg_tpu.utils.logging import get_logger
from pcmseg_tpu_torch.infer.fold_bn import fold_batchnorm, has_batchnorm
from pcmseg_tpu_torch.infer.sliding_window import make_sliding_window
from pcmseg_tpu_torch.infer.validate import (
    adopt_checkpoint_config,
    load_model_state,
    require_pth,
)
from pcmseg_tpu_torch.models.unet3d import DTYPES, UNet3D
from pcmseg_tpu_torch.train.checkpoints import load_pth


def _find_volume_file(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    for f in sorted(os.listdir(directory)):
        if f.lower().endswith(tuple(e.lower() for e in ALL_EXTS)):
            return os.path.join(directory, f)
    return None


def load_multimodal_images(
    case_dir: str,
    modalities: Sequence[str] = DEFAULT_MODALITIES,
    handle_missing: str = "zero_fill",
    normalize: str = "percentile",
    norm_percentiles: Tuple[float, float] = (1.0, 99.0),
    coregister: bool = False,
) -> Tuple[np.ndarray, Volume]:
    """Case dir with per-modality subdirs → ((D, H, W, C) float32, reference Volume).

    The first modality found is the spatial reference; the others are
    resampled onto its grid shape if they differ. Modalities are read and
    normalized on one thread each, capped at the host's cores (decode,
    resampling and the native normalize release the GIL); each thread owns
    its own channel of the stack.
    """
    decode_threads = max(1, min(len(modalities), os.cpu_count() or 1))

    def read(m: str) -> Optional[Volume]:
        path = _find_volume_file(os.path.join(case_dir, m))
        return read_volume(path) if path else None

    with ThreadPoolExecutor(max_workers=decode_threads) as pool:
        volumes: Dict[str, Optional[Volume]] = dict(zip(modalities, pool.map(read, modalities)))
    reference = next((volumes[m] for m in modalities if volumes[m] is not None), None)
    if reference is None:
        raise FileNotFoundError(
            f"no modality volumes found under {case_dir!r} (expected subdirs {list(modalities)})"
        )

    n_ch = len(modalities)
    out = np.empty((*reference.shape, n_ch), dtype=np.float32)

    def fill(i: int, m: str) -> None:
        vol = volumes[m]
        if vol is None:
            if handle_missing == "zero_fill":
                out[..., i] = 0
                return
            if handle_missing != "duplicate":
                raise FileNotFoundError(
                    f"modality {m!r} missing in {case_dir!r} (strategy={handle_missing})"
                )
            vol = reference
        if coregister:
            from pcmseg_tpu.data.resample import grids_match, resample_to_grid

            if not grids_match(vol, reference):
                vol = resample_to_grid(vol, reference, mode="linear")
        data = vol.data
        if data.shape != reference.shape:
            data = resample_array(data, reference.shape, mode="linear")
        fused = False
        if normalize in ("percentile", "minmax"):
            p_lo, p_hi = norm_percentiles if normalize == "percentile" else (0.0, 100.0)
            fused = native_normalize_into(data, p_lo, p_hi, out, offset=i, stride=n_ch)
        if not fused:  # zscore / none, exotic dtypes, or no native library
            out[..., i] = normalize_intensity(data, normalize, norm_percentiles)

    with ThreadPoolExecutor(max_workers=decode_threads) as pool:
        list(pool.map(lambda im: fill(*im), enumerate(modalities)))
    return out, reference


def expand_model_paths(checkpoint_path) -> List[str]:
    """One checkpoint spec (a path, a comma-separated list, a glob, or a
    list of these) → ordered list of paths."""
    specs = (
        [p for p in checkpoint_path.split(",") if p]
        if isinstance(checkpoint_path, str)
        else list(checkpoint_path)
    )
    paths = []
    for spec in specs:
        if glob.has_magic(spec):
            hits = sorted(glob.glob(spec))
            if not hits:
                raise FileNotFoundError(f"no checkpoints match {spec!r}")
            paths.extend(hits)
        else:
            paths.append(spec)
    return paths


def unported_options(config: Config) -> List[str]:
    """The config's Predictor options that this package has not ported."""
    refused = []
    if config.tta:
        refused.append("tta (flip-ensemble test-time augmentation)")
    if config.spatial_parallel > 1:
        refused.append(f"spatial_parallel={config.spatial_parallel}")
    if config.device_ingest:
        refused.append("device_ingest")
    if config.postprocess != "none":
        refused.append(f"postprocess={config.postprocess!r}")
    if config.min_component_voxels > 0:
        refused.append(f"min_component_voxels={config.min_component_voxels}")
    if config.n_classes >= 2:
        refused.append(f"n_classes={config.n_classes} (K-class serving)")
    if config.profile_dir:
        refused.append("profile_dir (profiling)")
    return refused


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


class Predictor:
    """Loads one ``.pth`` checkpoint once and segments cases on ``device``
    (default: the current CUDA device, else the CPU)."""

    def __init__(
        self,
        config: Config,
        checkpoint_path,
        explicit: Sequence[str] = (),
        device=None,
    ):
        paths = expand_model_paths(checkpoint_path)
        if len(paths) > 1:
            raise NotImplementedError(
                f"fold-ensemble serving ({len(paths)} checkpoints) is not ported "
                "to the PyTorch package yet"
            )
        require_pth(paths[0])
        loaded = load_pth(paths[0])  # read once: config snapshot and weights
        config = adopt_checkpoint_config(config, paths[0], explicit, loaded)
        refused = unported_options(config)
        if refused:
            raise NotImplementedError(
                "not ported to the PyTorch package yet: " + ", ".join(refused)
            )
        self.config = config
        self.log = get_logger("pcmseg.predict")
        self.device = torch.device(device) if device is not None else default_device()
        self.dtype = DTYPES[config.compute_dtype]
        if self.device.type == "cuda" and self.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"compute_dtype={config.compute_dtype!r} on CUDA: the conv kernel "
                "computes in bfloat16"
            )

        model, state_dict = load_model_state(config, paths[0], loaded)
        if config.fold_bn and config.norm_layer == "batch" and has_batchnorm(state_dict):
            # conv + BN -> conv: no norm op left, bias and ReLU fused in the kernel
            model = UNet3D.from_config(config, norm_layer="none", device="meta")
            model.load_state_dict(fold_batchnorm(state_dict), strict=True, assign=True)
        self.model = model.to(self.device).eval()
        self._sw_fns = {}  # per-volume-shape tiled predictors

    def _upload(self, image: np.ndarray) -> torch.Tensor:
        """(D, H, W, C) host array → device tensor in the compute dtype; on
        CUDA through pinned memory, one H2D copy."""
        image = np.asarray(image)
        if image.ndim != 4:
            raise ValueError(f"expected (D,H,W,C), got {image.shape}")
        host = torch.from_numpy(np.ascontiguousarray(image))
        if self.device.type != "cuda":
            return host.to(self.dtype)
        pinned = torch.empty(host.shape, dtype=self.dtype, pin_memory=True)
        pinned.copy_(host)
        return pinned.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def _predict_probs_device(self, image: np.ndarray) -> torch.Tensor:
        """(D, H, W, K) fp32 probabilities on the device."""
        x = self._upload(image)
        ws = self.config.window_size
        needs_tiling = self.config.sliding_window or any(
            s > w for s, w in zip(x.shape[:3], ws)
        )
        if not needs_tiling:
            return self.model.predict(x[None])[0]
        key = tuple(x.shape)
        if key not in self._sw_fns:
            self._sw_fns[key] = make_sliding_window(
                self.model.predict,
                key[:3],
                n_channels=key[3],
                n_out=self.config.n_classes,
                window_size=ws,
                overlap=self.config.window_overlap,
                blend=self.config.window_blend,
                tile_batch=self.config.window_tile_batch,
                device=self.device,
            )
        return self._sw_fns[key](x)

    def predict_probs(self, image: np.ndarray) -> np.ndarray:
        """(D, H, W, C) image → (D, H, W, K) sigmoid probabilities."""
        return self._predict_probs_device(image).cpu().numpy()

    def predict_mask(self, image: np.ndarray, threshold: Optional[float] = None) -> np.ndarray:
        """(D, H, W, C) image → (D, H, W) uint8 mask, thresholded on the device."""
        threshold = self.config.threshold if threshold is None else threshold
        probs = self._predict_probs_device(image)
        return (probs[..., 0] > threshold).to(torch.uint8).cpu().numpy()

    def load_case(
        self, case_dir: str, handle_missing: Optional[str] = None
    ) -> Tuple[np.ndarray, Volume]:
        """Host decode + normalize of one case dir → (image, reference Volume)."""
        cfg = self.config
        return load_multimodal_images(
            case_dir,
            modalities=cfg.modalities,
            handle_missing=handle_missing or cfg.missing_strategy,
            normalize=cfg.normalize,
            norm_percentiles=cfg.norm_percentiles,
            coregister=cfg.coregister,
        )

    def predict_case(
        self, case_dir: str, handle_missing: Optional[str] = None
    ) -> Tuple[np.ndarray, Volume]:
        """Case dir → (probabilities (D, H, W, K), reference Volume)."""
        image, reference = self.load_case(case_dir, handle_missing)
        return self.predict_probs(image), reference

    def save_mask(self, mask: np.ndarray, reference: Volume, output_path: str) -> str:
        """(D, H, W) uint8 mask → NIfTI/MHA with the reference's spatial
        metadata, written to a temporary name and renamed into place (the
        output's existence is the server's completion marker)."""
        out = Volume(mask).copy_information(
            reference if mask.shape == reference.shape else Volume(mask)
        )
        output_path = os.path.abspath(output_path)
        out_dir = os.path.dirname(output_path)
        os.makedirs(out_dir, exist_ok=True)
        tmp_path = os.path.join(out_dir, f".tmp-{os.getpid()}-{os.path.basename(output_path)}")
        try:
            write_volume(out, tmp_path)
            os.replace(tmp_path, output_path)
        finally:
            if os.path.exists(tmp_path):
                os.remove(tmp_path)
        self.log.info("prediction written to %s", output_path)
        return output_path

    def predict_and_save(
        self, case_dir: str, output_path: str, threshold: Optional[float] = None
    ) -> str:
        image, reference = self.load_case(case_dir)
        return self.save_mask(self.predict_mask(image, threshold), reference, output_path)
