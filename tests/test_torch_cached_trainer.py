"""The port's partial-cache ``Trainer`` against the JAX package's, on the CPU.

Both packages train from the same weights with ``device_data_cache_gb``
sized so that the partial cache engages: of the 4 train cases 3 are
resident and 1 streams, as does the val case, so each epoch runs 2 cached
steps and 1 streamed step in the Bresenham order, and validation streams.
Augmentation is off, so the batches are the same bytes in both packages.
Tolerances as in ``tests/test_torch_trainer.py``: losses 1e-4, val
Dice/IoU 2e-3.
"""

import jax
import numpy as np
import pytest
import torch

from pcmseg_tpu.core.config import get_config as jax_get_config
from pcmseg_tpu.data.synthetic import make_synthetic_dataset
from pcmseg_tpu.train.trainer import Trainer as JaxTrainer
from pcmseg_tpu_torch.core.config import get_config
from pcmseg_tpu_torch.data.device_cache import dataset_device_bytes
from pcmseg_tpu_torch.train.checkpoints import state_dict_from_jax_params
from pcmseg_tpu_torch.train.trainer import Trainer

SIZE = 32


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_synthetic_dataset(root, n_cases=5, shape=(34, 32, 30), seed=7)
    return root


def test_partial_cache_history_matches_jax_trainer(tree, tmp_path):
    kw = dict(
        data_dir=tree, cache_dir=str(tmp_path / "cache"), base_features=4, compute_dtype="float32", remat=False,
        conv_lowering="lax", target_size=(SIZE,) * 3, batch_size=2, num_epochs=2, early_stopping=False,
        data_parallel=1, seed=3, learning_rate=1e-4,
        device_data_cache_gb=3.5 * dataset_device_bytes(1, (SIZE,) * 3, 5) / 1e9,
    )
    jax_trainer = JaxTrainer(jax_get_config(save_dir=str(tmp_path / "jax"), **kw))
    trainer = Trainer(get_config(save_dir=str(tmp_path / "port"), **kw), device="cpu")
    for t in (jax_trainer, trainer):
        assert t._dcache_partial and len(t._res_train) == 3 and len(t._str_train) == 1
        assert t._res_val == [] and len(t._str_val) == 1
    assert trainer._res_train == jax_trainer._res_train and trainer._str_val == jax_trainer._str_val
    trainer.state.model.load_state_dict(
        state_dict_from_jax_params(
            jax.device_get(jax_trainer.state.params), jax.device_get(jax_trainer.state.batch_stats)
        )
    )
    want, got = jax_trainer.train(), trainer.train()
    assert sorted(got) == sorted(want)
    for k in want:
        atol = 2e-3 if k in ("val_dice", "val_iou") else 1e-4
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)
