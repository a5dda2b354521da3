"""Predictor: one case directory → uint8 NIfTI segmentation, on the GPU.

The port of ``pcmseg_tpu/infer/predict.py`` for ``.pth`` checkpoints:

  * host ingest: one subdirectory per modality, each holding one volume;
    missing modalities are zero-filled, duplicated from the reference
    modality, or refused (``skip``); every modality is normalized as in
    training and stacked (D, H, W, C);
  * one H2D copy per case from pinned host memory, in bf16 when the net
    computes in bf16 (it casts at its first layer, so rounding on the host
    changes nothing);
  * or, with ``config.device_ingest`` (``predict.py:151-215, 476-559``),
    device ingest: the host only decodes (and resamples) each modality
    (``load_multimodal_raw``); each present channel goes to the device raw,
    in its own dtype, through pinned memory, and the normalization
    (``normalize_intensity``'s semantics), the cast and the channel stack
    run there (``Predictor.ingest``). The stack then passes through the
    rest of the path untouched, tiled or not;
  * BN folded into the convs (``config.fold_bn``), so all 18 3³ convs run
    the CUDA kernel with bias and ReLU fused; a GroupNorm model is served
    unfolded (per-sample statistics cannot fold): each conv runs the kernel
    with its bias and no ReLU, then GroupNorm and ReLU;
  * a fold ensemble when several checkpoints are given: every member
    folded and resident on the device, its probabilities summed in fp32
    and divided by K (a loop over the members, where the JAX package
    scans over stacked weights);
  * the 2³ flip ensemble around that apply with ``config.tta``
    (``infer/tta.py``);
  * whole-volume inference when the image fits one window, on-device
    overlap tiling otherwise (each tile batch through the same apply);
  * sigmoid and threshold on the device, or for a K-class head softmax
    probabilities (averaged over members, flips and tiles) and their argmax
    label map on the device; one uint8 D2H copy, connected-component
    postprocessing on the host (``infer/postprocess.py``, per class for a
    label map), atomic write.

With ``spatial_parallel = n`` (``predict.py:375-415``) each member's
forward runs D-sharded over n shard devices in lockstep: one thread a
shard, each running the model on its D-slab under a
``collectives.spatial`` plan of its own, the halos and the GroupNorm sums
of an unfolded model going between the threads as device-to-device
copies (``collectives.LocalGroup``); the probabilities are gathered on the
Predictor's device. The shards are the first n cards when the host has
them (the caller may name them, e.g. ``["cuda:0", "cuda:0"]``, or
``["cpu"] * n``); with fewer, the Predictor logs a warning and serves
unsharded, as JAX's does. TTA flips the whole volume before the split,
the ensemble shards each member, and a volume up to n windows deep runs
whole (``d_cap``, ``predict.py:577-581``), its tiles through the sharded
forward above that.
``profile_dir`` is read by the callers (``cli/main.py``'s ``predict`` and
the server), not by the Predictor. ``pallas_inference`` is a TPU switch and
is ignored: on CUDA the hand-written kernel is the only conv.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pcmseg_tpu_torch.core.config import Config, DEFAULT_MODALITIES
from pcmseg_tpu_torch.data.io import ALL_EXTS, read_volume, write_volume
from pcmseg_tpu_torch.data.native import native_normalize_into
from pcmseg_tpu_torch.data.resample import normalize_intensity, resample_array
from pcmseg_tpu_torch.data.volume import Volume
from pcmseg_tpu_torch.utils.logging import get_logger
from pcmseg_tpu_torch.infer.fold_bn import fold_batchnorm, has_batchnorm
from pcmseg_tpu_torch.infer.postprocess import postprocess_from_config
from pcmseg_tpu_torch.infer.sliding_window import make_sliding_window
from pcmseg_tpu_torch.infer.tta import make_tta_apply
from pcmseg_tpu_torch.infer.validate import (
    adopt_checkpoint_config,
    load_model_state,
    require_pth,
)
from pcmseg_tpu_torch.models.unet3d import UNet3D, compute_dtype
from pcmseg_tpu_torch.parallel import collectives, multihost
from pcmseg_tpu_torch.parallel.sharding import level_plan
from pcmseg_tpu_torch.train.checkpoints import load_pth
from pcmseg_tpu_torch.utils.profiling import span


def _find_volume_file(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    for f in sorted(os.listdir(directory)):
        if f.lower().endswith(tuple(e.lower() for e in ALL_EXTS)):
            return os.path.join(directory, f)
    return None


def load_multimodal_raw(
    case_dir: str,
    modalities: Sequence[str] = DEFAULT_MODALITIES,
    handle_missing: str = "zero_fill",
    coregister: bool = False,
) -> Tuple[List[Optional[np.ndarray]], Volume]:
    """Case dir with per-modality subdirs → (per-modality raw (D, H, W)
    arrays in their own dtypes, reference Volume): decoded and resampled,
    not normalized, cast or stacked (the device ingest's host half).

    The first modality found is the spatial reference; the others are
    resampled onto its grid shape if they differ. A missing modality is
    None under ``zero_fill``, the reference's array under ``duplicate``,
    and a ``FileNotFoundError`` under ``skip``. Modalities are read on one
    thread each, capped at the host's cores (decode and resampling release
    the GIL).
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

        def channel(m: str) -> Optional[np.ndarray]:
            vol = volumes[m]
            if vol is None:
                if handle_missing == "zero_fill":
                    return None
                if handle_missing != "duplicate":
                    raise FileNotFoundError(
                        f"modality {m!r} missing in {case_dir!r} (strategy={handle_missing})"
                    )
                vol = reference
            if coregister:
                from pcmseg_tpu_torch.data.resample import grids_match, resample_to_grid

                if not grids_match(vol, reference):
                    vol = resample_to_grid(vol, reference, mode="linear")
            data = vol.data
            if data.shape != reference.shape:
                data = resample_array(data, reference.shape, mode="linear")
            return np.ascontiguousarray(data)

        return list(pool.map(channel, modalities)), reference


def load_multimodal_images(
    case_dir: str,
    modalities: Sequence[str] = DEFAULT_MODALITIES,
    handle_missing: str = "zero_fill",
    normalize: str = "percentile",
    norm_percentiles: Tuple[float, float] = (1.0, 99.0),
    coregister: bool = False,
) -> Tuple[np.ndarray, Volume]:
    """Case dir with per-modality subdirs → ((D, H, W, C) float32, reference Volume).

    The channels of :func:`load_multimodal_raw`, each normalized as in
    training on one thread (the native normalize releases the GIL) into its
    own channel of the stack; a zero-filled modality stays 0.
    """
    channels, reference = load_multimodal_raw(case_dir, modalities, handle_missing, coregister)
    n_ch = len(modalities)
    out = np.empty((*reference.shape, n_ch), dtype=np.float32)

    def fill(i: int, data: Optional[np.ndarray]) -> None:
        if data is None:
            out[..., i] = 0
            return
        fused = False
        if normalize in ("percentile", "minmax"):
            p_lo, p_hi = norm_percentiles if normalize == "percentile" else (0.0, 100.0)
            fused = native_normalize_into(data, p_lo, p_hi, out, offset=i, stride=n_ch)
        if not fused:  # zscore / none, exotic dtypes, or no native library
            out[..., i] = normalize_intensity(data, normalize, norm_percentiles)

    with ThreadPoolExecutor(max_workers=max(1, min(n_ch, os.cpu_count() or 1))) as pool:
        list(pool.map(fill, range(n_ch), channels))
    return out, reference


# raw dtypes that PyTorch has no CUDA arithmetic for, or that JAX's ingest
# (x64 off) casts on the host: converted to float32 there, before the upload
# (exact for uint16; 4 B/voxel on the wire where uint16 took 2, float64 8)
_HOST_FLOAT32 = {np.dtype(t) for t in ("uint16", "uint32", "uint64", "float64")}


def _wire_array(a: np.ndarray) -> np.ndarray:
    """A raw channel as it is uploaded: native byte order, C-contiguous,
    float32 for the dtypes of ``_HOST_FLOAT32``."""
    if a.dtype.newbyteorder("=") in _HOST_FLOAT32:
        return np.ascontiguousarray(a, dtype=np.float32)
    return np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("="))


def percentiles(x: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """``np.percentile(x, qs)`` with linear interpolation, as
    ``jnp.percentile`` computes it, in fp32 on x's device at any size
    (``torch.quantile`` refuses more than 2**24 elements): the sorted
    values at ``floor`` and ``ceil`` of ``q / 100 * (n - 1)``, weighted by
    the fractional part."""
    flat = torch.sort(x.reshape(-1).float()).values
    n = flat.numel()
    out = []
    for q in qs:
        # positions and weights on the host (no device tensor is built from
        # them, so nothing waits for the card); the weights are fp32 values
        pos = min(max(float(q) / 100.0 * (n - 1), 0.0), n - 1.0)
        w_hi = np.float32(pos - math.floor(pos))
        w_lo = np.float32(1.0) - w_hi
        out.append(flat[math.floor(pos)] * float(w_lo) + flat[math.ceil(pos)] * float(w_hi))
    return torch.stack(out)


def normalize_on_device(x: torch.Tensor, mode: str, norm_percentiles: Sequence[float]) -> torch.Tensor:
    """``normalize_intensity`` (``data/resample.py``) on x's device, in fp32:
    clip to the percentiles (or min/max) and scale to [0, 1], with 0 where
    the span is 0; or zero mean, unit variance (the std taken as 1 where it
    is 0); or the values as they are."""
    x = x.float()
    if mode == "none":
        return x
    if mode == "zscore":
        std = x.std(correction=0)
        return (x - x.mean()) / torch.where(std > 0, std, torch.ones_like(std))
    if mode == "percentile":
        lo, hi = percentiles(x, norm_percentiles)
        x = torch.minimum(torch.maximum(x, lo), hi)
    elif mode == "minmax":
        lo, hi = x.min(), x.max()
    else:
        raise ValueError(f"unknown normalize mode: {mode!r}")
    denom = hi - lo
    return torch.where(denom > 0, (x - lo) / denom, torch.zeros_like(x))


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


def _canonical(device: torch.device) -> torch.device:
    """``device`` with the current card's index where a CUDA device has none."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_device(device=None) -> torch.device:
    """``device``, by default the current CUDA device. A CUDA device without
    a card raises: the port runs on the CPU only when the caller asks for
    it (``device="cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device=\"cpu\" (--device cpu on the command line) "
            "to run on the CPU"
        )
    return device


class Predictor:
    """Loads one ``.pth`` checkpoint, or a fold ensemble of several, once
    and segments cases on ``device`` (default: the current CUDA device;
    without one, pass ``device="cpu"``)."""

    def __init__(
        self,
        config: Config,
        checkpoint_path=None,
        explicit: Sequence[str] = (),
        device=None,
        preloaded: Optional[Tuple[UNet3D, Dict[str, torch.Tensor]]] = None,
        shard_devices: Optional[Sequence] = None,
    ):
        """``checkpoint_path`` is one path, or several (a comma-separated
        list, a glob such as ``run/best_fold_*.pth``, or a list) for a fold
        ensemble, whose config is adopted from the first member.
        ``preloaded=(model, state_dict)`` serves an already loaded model
        (the Validator's) with ``config`` as it is, reading no checkpoint.
        ``shard_devices``: the ``spatial_parallel`` devices of a sharded
        forward, in D order (default: the host's first cards, if it has
        enough)."""
        self.log = get_logger("pcmseg.predict")
        if preloaded is None:
            if checkpoint_path is None:
                raise ValueError("checkpoint_path or preloaded required")
            paths = expand_model_paths(checkpoint_path)
            for path in paths:
                require_pth(path)
            loaded = load_pth(paths[0])  # read once: config snapshot and weights
            config = adopt_checkpoint_config(config, paths[0], explicit, loaded)
        self.config = config
        self.device = resolve_device(device)
        self.dtype = compute_dtype(config.compute_dtype)
        # the stack's dtype: bf16 for bf16 compute (the model casts at its
        # first layer, so rounding here is the same and halves the bytes),
        # fp32 otherwise (``predict.py:469-472, 636-637``)
        self.wire_dtype = torch.bfloat16 if self.dtype == torch.bfloat16 else torch.float32
        if preloaded is not None:
            self.models = [self._serving_model(*preloaded)]
        else:
            # one member at a time onto the device; the others must match the
            # first's architecture (strict loads)
            self.models = [self._serving_model(*load_model_state(config, paths[0], loaded))]
            self.models += [self._serving_model(*load_model_state(config, p)) for p in paths[1:]]
            if len(paths) > 1:
                self.log.info("fold-ensemble serving: %d checkpoints (%s)", len(paths), ", ".join(paths))
        self.shards = self._shard_devices(shard_devices)
        # the members on each shard device (a copy where it is not the Predictor's)
        self.replicas: Dict[str, List[UNet3D]] = {}
        if self.shards is None:
            self._members = [m.predict for m in self.models]
        else:
            home = _canonical(self.device)
            self.replicas = {str(d): [m if _canonical(d) == home else copy.deepcopy(m).to(d) for m in self.models]
                             for d in dict.fromkeys(self.shards)}
            self._pool = ThreadPoolExecutor(max_workers=len(self.shards), thread_name_prefix="pcmseg-shard")
            self._members = [self._sharded_apply([self.replicas[str(d)][i] for d in self.shards])
                             for i in range(len(self.models))]
        apply = self._members[0] if len(self._members) == 1 else self._ensemble_apply
        self._apply = make_tta_apply(apply) if config.tta else apply
        self._sw_fns = {}  # per-volume-shape tiled predictors

    def _shard_devices(self, given: Optional[Sequence]) -> Optional[List[torch.device]]:
        """The devices of the sharded forward, or None to serve unsharded."""
        n = int(self.config.spatial_parallel)
        if given is not None:
            devices = [torch.device(d) for d in given]
            if n < 2 or len(devices) != n:
                raise ValueError(f"{len(devices)} shard devices for spatial_parallel={n}")
            return devices
        if n < 2:
            return None
        local = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if multihost.process_count() == 1 and local >= n:
            return [torch.device("cuda", i) for i in range(n)]
        self.log.warning(
            "spatial_parallel=%d requested but %d local device(s) available in %d process(es); "
            "serving unsharded", n, local, multihost.process_count(),
        )
        return None

    def _sharded_apply(self, replicas: List[UNet3D]):
        """(N, D, H, W, C) → (N, D, H, W, K) probabilities on the Predictor's
        device, through one member's ``replicas`` (one a shard device), each
        on its D-slab in a thread of its own."""

        def apply(x: torch.Tensor) -> torch.Tensor:
            levels = level_plan(x.shape[1], len(replicas))
            group = collectives.LocalGroup(len(replicas))

            def run(rank: int) -> torch.Tensor:
                device = self.shards[rank]
                start, stop = levels.slabs[0][rank]
                plan = collectives.SpatialPlan(group.member(rank), levels)
                cuda = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
                try:
                    with torch.inference_mode(), cuda, collectives.spatial(plan, this_thread=True):
                        return replicas[rank].predict(x[:, start:stop].to(device))
                except BaseException:
                    group.abort()  # the other shards leave their barrier now
                    raise

            futures = [self._pool.submit(run, r) for r in range(len(replicas))]
            slabs = [f.result() for f in futures]
            return torch.cat([p.to(self.device) for p in slabs], 1)

        return apply

    def _serving_model(self, model: UNet3D, state_dict: Dict[str, torch.Tensor]) -> UNet3D:
        cfg = self.config
        if cfg.fold_bn and cfg.norm_layer == "batch" and has_batchnorm(state_dict):
            # conv + BN -> conv: no norm op left, bias and ReLU fused in the kernel
            model = UNet3D.from_config(cfg, norm_layer="none", device="meta")
            model.load_state_dict(fold_batchnorm(state_dict), strict=True, assign=True)
        return model.to(self.device).eval()

    def _ensemble_apply(self, x: torch.Tensor) -> torch.Tensor:
        """The members' mean probability, summed in fp32 in member order."""
        total = None
        for member in self._members:
            p = member(x)
            total = p if total is None else total + p
        return total / len(self._members)

    def _upload(self, image) -> torch.Tensor:
        """Host array → device tensor in the wire dtype; on CUDA through
        pinned memory, one H2D copy. A tensor (the device-ingested stack)
        passes through as it is."""
        if isinstance(image, torch.Tensor):
            return image.to(self.device, self.wire_dtype)
        host = torch.from_numpy(np.ascontiguousarray(image))
        if self.device.type != "cuda":
            return host.to(self.wire_dtype)
        pinned = torch.empty(host.shape, dtype=self.wire_dtype, pin_memory=True)
        pinned.copy_(host)
        return pinned.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def _predict_probs_device(self, image) -> torch.Tensor:
        """(D, H, W, K) fp32 probabilities on the device, from a host array
        or the device-ingested stack."""
        if not isinstance(image, torch.Tensor):
            image = np.asarray(image)
        if image.ndim != 4:
            raise ValueError(f"expected (D,H,W,C), got {tuple(image.shape)}")
        x = self._upload(image)
        ws = self.config.window_size
        # sharded, a card holds 1/n of the D axis: volumes n windows deep run whole
        d_cap = ws[0] * (len(self.shards) if self.shards is not None else 1)
        needs_tiling = self.config.sliding_window or any(
            s > w for s, w in zip(x.shape[:3], (d_cap, ws[1], ws[2]))
        )
        if not needs_tiling:
            return self._apply(x[None])[0]
        key = tuple(x.shape)
        if key not in self._sw_fns:
            self._sw_fns[key] = make_sliding_window(
                self._apply,
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

    def predict_probs(self, image) -> np.ndarray:
        """(D, H, W, C) image → (D, H, W, K) probabilities (sigmoid, or
        softmax over the K classes)."""
        return self._predict_probs_device(image).cpu().numpy()

    @torch.inference_mode()
    def predict_probs_batch(self, images) -> np.ndarray:
        """(N, D, H, W, C) window-sized batch → (N, D, H, W, K)
        probabilities, whole-volume (no tiling): for callers whose inputs
        already fit one window, as ensemble validation's target_size cases."""
        if not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        if images.ndim != 5:
            raise ValueError(f"expected (N,D,H,W,C), got {tuple(images.shape)}")
        return self._apply(self._upload(images)).cpu().numpy()

    def predict_mask(self, image, threshold: Optional[float] = None) -> np.ndarray:
        """(D, H, W, C) image → (D, H, W) uint8 mask, thresholded on the
        device (for a K-class head the argmax label map of the fp32
        probabilities, ``threshold`` unused), then postprocessed as the
        config says."""
        threshold = self.config.threshold if threshold is None else threshold
        with span("serve.dispatch"):
            probs = self._predict_probs_device(image)
            if self.config.n_classes >= 2:
                mask = probs.argmax(-1).to(torch.uint8)
            else:
                mask = (probs[..., 0] > threshold).to(torch.uint8)
        with span("serve.fetch"):
            mask = mask.cpu().numpy()
        with span("serve.postprocess"):
            return postprocess_from_config(mask, self.config)

    def read_case(self, case_dir: str, handle_missing: Optional[str] = None):
        """The host half of one case's ingest, with no device work (the
        server's prefetch thread runs it): (the raw channels under
        ``device_ingest``, else the normalized (D, H, W, C) float32 stack;
        the reference Volume)."""
        cfg = self.config
        handle_missing = handle_missing or cfg.missing_strategy
        if cfg.device_ingest:
            return load_multimodal_raw(
                case_dir, modalities=cfg.modalities, handle_missing=handle_missing, coregister=cfg.coregister
            )
        return load_multimodal_images(
            case_dir,
            modalities=cfg.modalities,
            handle_missing=handle_missing,
            normalize=cfg.normalize,
            norm_percentiles=cfg.norm_percentiles,
            coregister=cfg.coregister,
        )

    def ingest(self, image):
        """The device half: under ``device_ingest`` the raw channels of
        ``read_case`` → the normalized stack on the device; a host stack
        is returned as it is (``_upload`` copies it)."""
        return self._device_ingest_stack(image) if self.config.device_ingest else image

    def load_case(self, case_dir: str, handle_missing: Optional[str] = None):
        """One case dir → (image, reference Volume): a host array, or under
        ``device_ingest`` the (D, H, W, C) stack on the device
        (``predict.py:538-559``)."""
        image, reference = self.read_case(case_dir, handle_missing)
        return self.ingest(image), reference

    def _device_ingest_stack(self, channels: Sequence[Optional[np.ndarray]]) -> torch.Tensor:
        """Raw per-modality host arrays (None: zero-filled) → the normalized
        (D, H, W, C) stack on the device in the wire dtype
        (``predict.py:476-536``). Each present channel is uploaded in its own
        dtype (int16: the 2 B/voxel of the bf16 wire) through pinned memory,
        then normalized in fp32, cast and stacked there."""
        shape = next(c.shape for c in channels if c is not None)
        cfg = self.config
        stack = []
        for c in channels:
            if c is None:
                stack.append(torch.zeros(shape, dtype=torch.float32, device=self.device))
                continue
            a = _wire_array(c)
            if self.device.type == "cuda":
                # numpy copies the (possibly read-only) array into pinned memory
                dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
                pinned = torch.empty(a.shape, dtype=dtype, pin_memory=True)
                pinned.numpy()[...] = a
                x = pinned.to(self.device, non_blocking=True)
            else:
                x = torch.from_numpy(a if a.flags.writeable else a.copy())
            stack.append(normalize_on_device(x, cfg.normalize, cfg.norm_percentiles))
        return torch.stack(stack, dim=-1).to(self.wire_dtype)

    def predict_case(
        self, case_dir: str, handle_missing: Optional[str] = None
    ) -> Tuple[np.ndarray, Volume]:
        """Case dir → (probabilities (D, H, W, K), reference Volume), through
        the host or the device ingest as the config says."""
        image, reference = self.load_case(case_dir, handle_missing)
        return self.predict_probs(image), reference

    def save_prediction(
        self,
        probs: np.ndarray,
        reference: Volume,
        output_path: str,
        threshold: Optional[float] = None,
    ) -> str:
        """(D, H, W, K) probabilities → thresholded (binary) or argmax
        (K-class) uint8 mask or label map, postprocessed → NIfTI/MHA with
        the reference's spatial metadata."""
        threshold = self.config.threshold if threshold is None else threshold
        if self.config.n_classes >= 2:
            mask = np.argmax(probs, axis=-1).astype(np.uint8)
        else:
            mask = (probs[..., 0] > threshold).astype(np.uint8)
        return self.save_mask(postprocess_from_config(mask, self.config), reference, output_path)

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
