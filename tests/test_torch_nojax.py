"""pcmseg_tpu_torch runs with JAX and the JAX package absent: every module
imports, a tiny Predictor segments a volume, a train step runs, one
cross-validation fold trains, a Validator scores a two-checkpoint ensemble
with TTA, and a deep-supervision model trains a cached epoch cropped and
augmented on the device, on the CPU, with pcmseg_tpu, jax, flax, optax,
orbax and ml_dtypes blocked in sys.modules of a fresh interpreter (every
module imports, ``parallel/`` included); and no module of the port or
``chip_smoke.py`` imports pcmseg_tpu or JAX."""

import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib, os, pkgutil, sys, tempfile
    for name in ("pcmseg_tpu", "jax", "flax", "optax", "orbax", "ml_dtypes"):
        sys.modules[name] = None  # any import of them raises ImportError

    import numpy as np
    import torch

    torch.set_num_threads(2)
    import pcmseg_tpu_torch

    modules = [m.name for m in pkgutil.walk_packages(pcmseg_tpu_torch.__path__, "pcmseg_tpu_torch.")]
    for name in modules:
        importlib.import_module(name)
    assert {"pcmseg_tpu_torch.parallel." + m for m in ("multihost", "sharding", "collectives")} <= set(modules)

    from pcmseg_tpu_torch.cli.main import main
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.data.nifti import write_nifti
    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.train.checkpoints import save_pth

    config = get_config(base_features=4, compute_dtype="float32")
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as d:
        pth = save_pth(os.path.join(d, "m.pth"), model.state_dict(), config.to_dict())
        predictor = Predictor(config, pth, device="cpu")
        image = np.random.default_rng(0).normal(size=(16, 16, 16, 5)).astype(np.float32)
        mask = predictor.predict_mask(image)
        assert mask.shape == (16, 16, 16) and mask.dtype == np.uint8
        case = os.path.join(d, "case")
        for m in config.modalities:
            os.makedirs(os.path.join(case, m))
            write_nifti(image[..., 0], os.path.join(case, m, "t.nii.gz"))
        assert main(["predict", "--model_path", pth, "--input_dir", case,
                     "--output_dir", os.path.join(d, "out"), "--device", "cpu"]) == 0
        assert os.path.exists(os.path.join(d, "out", "segmentation.nii.gz"))
    # one train step (forward, loss, backward, clip, Adam, BN statistics)
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

    train_cfg = get_config(base_features=4, compute_dtype="float32", batch_size=2, accum_steps=2)
    model = UNet3D.from_config(train_cfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, train_cfg)
    rng = np.random.default_rng(1)
    batch = {"image": torch.from_numpy(rng.normal(size=(2, 16, 16, 16, 5)).astype(np.float32)),
             "label": torch.from_numpy((rng.random((2, 16, 16, 16, 1)) > 0.5).astype(np.uint8))}
    before = model.inc.conv[0].weight.detach().clone()
    metrics = make_train_step(model, train_cfg)(state, batch)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    assert not torch.equal(before, model.inc.conv[0].weight)
    assert int(model.inc.conv[1].num_batches_tracked) == 2

    # one cross-validation fold, then the Validator over a fold ensemble with TTA
    from pcmseg_tpu_torch.infer.validate import Validator
    from pcmseg_tpu_torch.train.cv import CrossValidationTrainer

    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(2)
        for i in range(4):
            for m in config.modalities:
                os.makedirs(os.path.join(d, "BPH-PCA", "BPH", m), exist_ok=True)
                write_nifti(rng.normal(size=(18, 16, 17)).astype(np.float32),
                            os.path.join(d, "BPH-PCA", "BPH", m, f"c{i}.nii.gz"))
            os.makedirs(os.path.join(d, "BPH-PCA", "ROI(BPH+PCA)", "BPH"), exist_ok=True)
            write_nifti((rng.random((18, 16, 17)) > 0.8).astype(np.uint8),
                        os.path.join(d, "BPH-PCA", "ROI(BPH+PCA)", "BPH", f"c{i}.nii.gz"))
        cv_cfg = get_config(data_dir=d, save_dir=os.path.join(d, "ckpt"), cache_dir=os.path.join(d, "cache"),
                            base_features=4, compute_dtype="float32", target_size=(16, 16, 16), batch_size=2,
                            num_epochs=1, n_splits=2)
        fold = CrossValidationTrainer(cv_cfg, device="cpu").train_fold(0)
        assert fold["epochs_trained"] == 1 and np.isfinite(fold["best_val_loss"])
        other = save_pth(os.path.join(d, "other.pth"), UNet3D.from_config(cv_cfg).state_dict(), cv_cfg.to_dict())
        results = Validator(cv_cfg.replace(tta=True, surface_metrics=True),
                            [os.path.join(d, "ckpt", "best_fold_0.pth"), other], device="cpu").validate()
        assert results["case_count"] == 4 and results["surface_units"] == "voxel"

        # a cached epoch of a deep-supervision model, cropped and augmented on the device
        from pcmseg_tpu_torch.data import device_cache
        from pcmseg_tpu_torch.train.trainer import Trainer

        aug_cfg = cv_cfg.replace(target_size=(20, 20, 20), train_crop=(16, 16, 16), oversample_fg=0.5,
                                 data_augmentation=True, aug_scale=0.15, aug_rotate_deg=15.0, aug_gamma=0.3,
                                 aug_noise=0.1, aug_blur_prob=1.0, deep_supervision=True,
                                 save_dir=os.path.join(d, "aug"))
        before = device_cache.uploads
        trainer = Trainer(aug_cfg, device="cpu")
        assert trainer._dcache is not None and device_cache.uploads == before + 1
        assert trainer.state.model.deep_supervision
        assert np.isfinite(trainer.train_epoch())
    print("modules", len(modules))
    """
)


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    n_modules = int(proc.stdout.split("modules")[-1])
    assert n_modules >= 35


def _imported_modules(path):
    """Every module name an import statement of the file at ``path`` names."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_of_the_port_imports_the_jax_package():
    """Nor JAX or its libraries: the port's modules (``parallel/`` among
    them) and ``chip_smoke.py`` import none of pcmseg_tpu, jax, flax, optax
    and orbax."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pcmseg_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    offenders = [
        f"{os.path.relpath(path, REPO)}: {name}"
        for path in files
        for name in _imported_modules(path)
        if name.split(".")[0] in ("pcmseg_tpu", "jax", "jaxlib", "flax", "optax", "orbax")
    ]
    assert offenders == []
