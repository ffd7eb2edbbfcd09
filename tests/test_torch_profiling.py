"""The port's profiling (utils/profiling.py, Trainer.profile_epoch, the
train CLI's --profile-dir) on the CPU, against the JAX package's contract:
one trace file a rank, valid Chrome-trace JSON with events; profile_epoch
writing the trace, no metrics.csv, and two epochs of steps whose state
equals two runs of the shared step helper over the same permutation, bit
for bit; the train CLI's --profile-dir as tests/test_profile_cli.py checks
the JAX CLI, and its refusal under --stream / --strict-items with the JAX
CLI's return code and message. The stage spans: tests/test_torch_spans.py."""

import dataclasses
import json
import os

import pytest
import torch

from ctr_recommendation_tpu.cli.train import main as jax_train_main
from ctr_recommendation_tpu_torch.cli.train import main as train_main
from ctr_recommendation_tpu_torch.config import microlens_experiment
from ctr_recommendation_tpu_torch.config.loader import microlens_features
from ctr_recommendation_tpu_torch.data import synthetic_splits
from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten
from ctr_recommendation_tpu_torch.training import Trainer
from ctr_recommendation_tpu_torch.utils import trace

torch.set_num_threads(2)

ROWS, BS = 320, 64  # 5 steps an epoch


def _events(log_dir):
    files = os.listdir(log_dir)
    assert files == ["rank0.pt.trace.json"], files
    with open(os.path.join(log_dir, files[0])) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_one_json_trace_with_events(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "prof")):
        y = (x @ x).relu().sum()
    assert torch.isfinite(y)
    names = {e.get("name", "") for e in _events(tmp_path / "prof")}
    assert any("mm" in n for n in names), sorted(names)[:20]


def test_trace_propagates_errors(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with trace(str(tmp_path / "prof")):
            1 / 0


def _trainer(ckpt):
    exp = microlens_experiment(
        data_root="", embedding_dim=16, hidden_units=(32, 16), batch_size=BS, epochs=2,
        max_len=8, checkpoint_dir=str(ckpt), async_checkpointing=False, tensorboard=False)
    exp = exp.replace(dataset=dataclasses.replace(exp.dataset, features=microlens_features(
        item_vocab=200, cate_vocab=11, max_len=8, mm_dim=24)))
    train, _, store = synthetic_splits(ROWS, 64, num_items=199, max_len=8, mm_dim=24,
                                       num_users=100, seed=0)
    return Trainer(exp, steps_per_epoch=ROWS // BS, item_store=store, device="cpu",
                   log_fn=lambda s: None), train


def test_profile_epoch_writes_the_trace_and_runs_two_epochs(tmp_path):
    tr, train = _trainer(tmp_path / "a")
    lines = []
    tr.log = lines.append
    tr.profile_epoch(train, str(tmp_path / "prof"))
    assert lines == [f"[profile] trace written to {tmp_path / 'prof'}"]
    assert _events(tmp_path / "prof")
    assert tr.state.step == 2 * (ROWS // BS)
    assert not (tmp_path / "a" / "metrics.csv").exists()
    assert not tr.history

    # the same two epochs through the shared step helper, outside the trace
    ref, _ = _trainer(tmp_path / "b")
    data = ref._upload(train)
    perm = torch.randperm(ROWS, generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        ref._device_epoch(data, perm, ROWS // BS, ref._rank_rows(BS))
    assert ref.state.step == tr.state.step
    for (k, got), want in zip(flatten(tr.state.params).items(),
                              flatten(ref.state.params).values()):
        assert torch.equal(got, want), k
    for (k, got), want in zip(flatten(tr.state.model_state).items(),
                              flatten(ref.state.model_state).values()):
        assert torch.equal(got, want), k


@pytest.fixture(scope="module")
def synthetic_dir(tmp_path_factory):
    from ctr_recommendation_tpu_torch.data import write_synthetic_dataset

    root = str(tmp_path_factory.mktemp("synthetic"))
    write_synthetic_dataset(root, num_rows=3000, num_items=300)
    return root


CLI = ["--synthetic-items", "300", "--epochs", "1", "--embedding-dim", "16",
       "--batch-size", "256"]


def test_train_cli_profile_dir(synthetic_dir, tmp_path):
    ckpt, prof = tmp_path / "ckpt", tmp_path / "prof"
    rc = train_main(["--synthetic", synthetic_dir, *CLI, "--checkpoint-dir", str(ckpt),
                     "--device", "cpu", "--profile-dir", str(prof)])
    assert rc == 0
    assert _events(prof)
    assert not (ckpt / "metrics.csv").exists()
    assert not (ckpt / "best").exists()


@pytest.mark.parametrize("flag", ["--stream", "--strict-items"])
def test_train_cli_profile_dir_refuses_host_driven_paths(flag, synthetic_dir, tmp_path, capsys):
    argv = ["--synthetic", synthetic_dir, *CLI, "--profile-dir", str(tmp_path / "prof"), flag]
    assert jax_train_main([*argv, "--checkpoint-dir", str(tmp_path / "jax"), "--no-pallas"]) == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert train_main([*argv, "--checkpoint-dir", str(tmp_path / "pt"), "--device", "cpu"]) == 2
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got == want == ("--profile-dir requires the in-memory, non-strict path "
                           "(drop --stream/--strict-items)")
    assert not (tmp_path / "prof").exists()
