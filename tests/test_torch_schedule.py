"""Port's LR schedules and early stopping (train/schedule.py) against the JAX
package's ``pcmseg_tpu.train.schedule``: the same LR sequence over a fixed
sequence of monitored losses, the same stop decisions, and state dicts that
round-trip through ``load_state_dict``."""

import pytest

from pcmseg_tpu.core.config import get_config
from pcmseg_tpu.train import schedule as jax_schedule
from pcmseg_tpu_torch.train import schedule

# improving, then flat, then worse: every plateau/cooldown branch fires
LOSSES = [1.0, 0.9, 0.85, 0.85, 0.86, 0.849, 0.9, 0.95, 0.95, 0.95, 0.97, 0.99, 0.8, 0.8, 0.81, 0.82]


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("kind", ["reduce_on_plateau", "cosine", "poly", "constant"])
def test_lr_sequence_matches_jax(kind, warmup):
    config = get_config(scheduler=kind, warmup_epochs=warmup, num_epochs=len(LOSSES),
                        plateau_patience=2, plateau_cooldown=1, learning_rate=1e-3, min_lr=1e-6)
    ours, theirs = schedule.make_scheduler(config), jax_schedule.make_scheduler(config)
    assert type(ours).__name__ == type(theirs).__name__
    seq_ours, seq_theirs = [ours.lr], [theirs.lr]
    for i, loss in enumerate(LOSSES):
        seq_ours.append(ours.step(loss))
        seq_theirs.append(theirs.step(loss))
        if i == len(LOSSES) // 2:  # resume mid-run: a fresh schedule from the state dict
            fresh = schedule.make_scheduler(config)
            fresh.load_state_dict(ours.state_dict())
            assert fresh.state_dict() == ours.state_dict() == theirs.state_dict()
            ours = fresh
    assert seq_ours == seq_theirs
    assert len(set(seq_ours)) > 1 or kind == "constant"


@pytest.mark.parametrize("mode,min_delta", [("min", 0.0), ("min", 0.02), ("max", 0.0)])
def test_early_stopping_matches_jax(mode, min_delta):
    ours = schedule.EarlyStopping(patience=3, mode=mode, min_delta=min_delta)
    theirs = jax_schedule.EarlyStopping(patience=3, mode=mode, min_delta=min_delta)
    decisions = []
    for i, loss in enumerate(LOSSES):
        decisions.append((ours.step(loss), theirs.step(loss)))
        if i == 5:
            fresh = schedule.EarlyStopping(patience=3, mode=mode, min_delta=min_delta)
            fresh.load_state_dict(ours.state_dict())
            ours = fresh
        assert ours.state_dict() == theirs.state_dict()
    assert all(a == b for a, b in decisions)
    assert any(a for a, _ in decisions)
