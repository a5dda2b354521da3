"""pcmseg_tpu_torch runs with JAX and the JAX package absent: every module
imports, a tiny Predictor segments a volume and a train step runs on the
CPU, with pcmseg_tpu, jax, flax, optax, orbax and ml_dtypes blocked in
sys.modules of a fresh interpreter; and no module of the port or
``chip_smoke.py`` imports pcmseg_tpu."""

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
    assert n_modules >= 25


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
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pcmseg_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    offenders = [
        f"{os.path.relpath(path, REPO)}: {name}"
        for path in files
        for name in _imported_modules(path)
        if name == "pcmseg_tpu" or name.startswith("pcmseg_tpu.")
    ]
    assert offenders == []
