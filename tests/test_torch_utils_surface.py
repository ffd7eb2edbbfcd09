"""The port's utils and package surface against the JAX package's, on the
CPU: set_seed seeds ``random`` and ``numpy`` exactly as the JAX set_seed
does and returns a seeded torch generator, leaving torch's global one
alone; the Trainer mirrors metrics.csv to TensorBoard event files under
``<checkpoint_dir>/tb`` when ``train.tensorboard`` is on, and writes none
when it is off; the lazy package attributes resolve to the port's objects,
``__version__`` is the JAX package's, and a bare import of the package loads
neither jax nor any of the port's modules and touches no CUDA context."""

import dataclasses
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ctr_recommendation_tpu
import ctr_recommendation_tpu_torch
from ctr_recommendation_tpu.utils import set_seed as jax_set_seed
from ctr_recommendation_tpu_torch.config import microlens_experiment
from ctr_recommendation_tpu_torch.config.loader import microlens_features
from ctr_recommendation_tpu_torch.data import synthetic_splits
from ctr_recommendation_tpu_torch.training import Trainer
from ctr_recommendation_tpu_torch.utils import set_seed
from ctr_recommendation_tpu_torch.utils.tb import ScalarWriter

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _draws():
    return [random.random() for _ in range(3)], np.random.rand(3), np.random.randint(0, 1000, 4)


def test_set_seed_seeds_random_and_numpy_as_jax_does():
    jax_set_seed(7)
    want = _draws()
    set_seed(7, device="cpu")
    got = _draws()
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_set_seed_returns_a_seeded_generator_and_leaves_torchs_global_one():
    before = torch.random.get_rng_state()
    a, b = set_seed(7, device="cpu"), set_seed(7, device="cpu")
    assert isinstance(a, torch.Generator) and a.device == torch.device("cpu")
    assert a.initial_seed() == 7
    assert torch.equal(torch.rand(8, generator=a), torch.rand(8, generator=b))
    assert not torch.equal(torch.rand(8, generator=set_seed(8, device="cpu")),
                           torch.rand(8, generator=set_seed(7, device="cpu")))
    assert torch.equal(torch.random.get_rng_state(), before)


def test_set_seed_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        set_seed(7)


def _event_files(d):
    return [f for f in os.listdir(d) if f.startswith("events.out.tfevents")] if d.exists() else []


@pytest.mark.parametrize("on", [True, False])
def test_trainer_mirrors_metrics_to_tensorboard(on, tmp_path):
    exp = microlens_experiment(
        data_root="", embedding_dim=16, hidden_units=(32, 16), batch_size=64, epochs=2,
        max_len=8, checkpoint_dir=str(tmp_path), async_checkpointing=False, tensorboard=on)
    exp = exp.replace(dataset=dataclasses.replace(exp.dataset, features=microlens_features(
        item_vocab=200, cate_vocab=11, max_len=8, mm_dim=24)))
    train, valid, store = synthetic_splits(256, 128, num_items=199, max_len=8, mm_dim=24,
                                           num_users=100, seed=0)
    tr = Trainer(exp, steps_per_epoch=4, item_store=store, device="cpu", log_fn=lambda s: None)
    assert tr._tb.active == on
    history = tr.fit_on_device(train, valid)
    assert len(history) == 2 and (tmp_path / "metrics.csv").exists()
    events = _event_files(tmp_path / "tb")
    if not on:
        assert events == [] and not (tmp_path / "tb").exists()
        return
    assert len(events) == 1
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert {"train_loss", "auc", "logloss"} <= set(acc.Tags()["scalars"])
    loss = acc.Scalars("train_loss")
    assert [e.step for e in loss] == [1, 2]
    np.testing.assert_allclose([e.value for e in loss], [h["train_loss"] for h in history],
                               rtol=1e-6)


def test_scalar_writer_is_a_no_op_without_a_logdir(tmp_path):
    w = ScalarWriter(None)
    assert not w.active
    w.scalars(1, {"auc": 0.5})
    w.close()
    w = ScalarWriter(str(tmp_path / "tb"))
    assert w.active
    w.scalars(3, {"auc": 0.5, "note": "not a number"})
    w.close()
    assert not w.active and len(_event_files(tmp_path / "tb")) == 1


def test_lazy_package_attributes_and_version():
    from ctr_recommendation_tpu_torch.config import microlens_experiment as me
    from ctr_recommendation_tpu_torch.inference import Predictor
    from ctr_recommendation_tpu_torch.models import build_model

    assert ctr_recommendation_tpu_torch.Trainer is Trainer
    assert ctr_recommendation_tpu_torch.Predictor is Predictor
    assert ctr_recommendation_tpu_torch.build_model is build_model
    assert ctr_recommendation_tpu_torch.microlens_experiment is me
    assert ctr_recommendation_tpu_torch.__version__ == ctr_recommendation_tpu.__version__
    assert sorted(ctr_recommendation_tpu_torch.__all__) == sorted(ctr_recommendation_tpu.__all__)
    with pytest.raises(AttributeError):
        ctr_recommendation_tpu_torch.NoSuchThing  # noqa: B018


def test_importing_the_package_loads_nothing_else():
    code = (
        "import sys, torch\n"
        "import ctr_recommendation_tpu_torch as p\n"
        "mods = sorted(m for m in sys.modules if m.startswith(('ctr_', 'jax')))\n"
        "assert mods == ['ctr_recommendation_tpu_torch', 'ctr_recommendation_tpu_torch.version'],"
        " mods\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert p.__version__ == '0.1.0'\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
