"""The port's group AUC and evaluate CLI against the JAX package's (CPU).

``group_auc`` against the JAX ``group_auc`` within 1e-6 (ties, groups of
one class, one group, empty input); ``group_auc_device`` on arbitrary int
codes. Then both evaluate CLIs on one JAX-trained checkpoint, the port's
through weights bridged with tools/jax_bridge.save: the same ``[data]``
line, AUC, logloss and gAUC[user_id] within 1e-5 in fp32 and 2e-3 in bf16,
the same ``[eval]`` format, and exit 2 with the same message on a split
without labels and on a ``--gauc-col`` that is not a column.
"""

import contextlib
import dataclasses
import io
import json
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.training.metrics import group_auc as jax_group_auc
from ctr_recommendation_tpu_torch.training.metrics import group_auc, group_auc_device

torch.set_num_threads(2)


def _groups_case(name):
    rng = np.random.default_rng(len(name))
    n = 2000
    labels = (rng.random(n) < 0.3).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    groups = rng.integers(0, 60, n)
    if name == "ties":
        scores = (np.round(scores * 20) / 20).astype(np.float32)
    elif name == "single-class-groups":
        labels[groups % 3 == 0] = 1.0  # a third of the groups all positive
        labels[groups % 3 == 1] = 0.0  # a third all negative
    elif name == "one-group":
        groups = np.full(n, 7)
    elif name == "no-group-has-both":
        labels = (groups % 2).astype(np.float32)
    elif name == "string-keys":
        groups = np.array([f"u{g}" for g in groups])
    return labels, scores, groups


@pytest.mark.parametrize("name", ["random", "ties", "single-class-groups", "one-group",
                                  "no-group-has-both", "string-keys"])
def test_group_auc_matches_jax(name):
    labels, scores, groups = _groups_case(name)
    want = jax_group_auc(labels, scores, groups)
    got = group_auc(labels, scores, groups, device="cpu")
    assert abs(got - want) < 1e-6, (got, want)
    if name == "no-group-has-both":
        assert got == 0.5


def test_group_auc_of_nothing_is_one_half():
    assert group_auc([], [], [], device="cpu") == 0.5 == jax_group_auc([], [], [])


def test_group_auc_device_takes_arbitrary_int_codes():
    """Codes need not be dense: negative, large and sparse codes give the
    value of their factorized keys, and of a per-group loop over ``auc``."""
    from ctr_recommendation_tpu_torch.training.metrics import auc

    labels, scores, groups = _groups_case("ties")
    codes = (groups.astype(np.int64) - 30) * 1_000_003
    got = group_auc_device(torch.from_numpy(labels), torch.from_numpy(scores),
                           torch.from_numpy(codes)).item()
    assert abs(got - jax_group_auc(labels, scores, groups)) < 1e-6
    num = den = 0.0
    for g in np.unique(codes):
        m = codes == g
        if 0 < labels[m].sum() < m.sum():
            num += m.sum() * auc(torch.from_numpy(labels[m]), torch.from_numpy(scores[m])).item()
            den += m.sum()
    assert abs(got - num / den) < 1e-6


# ------------------------------------------------------- the evaluate CLIs
@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A tiny synthetic dataset (40 users, so user groups hold both
    classes), an mm_fibinet checkpoint trained one epoch by the JAX package,
    and its best export bridged to the port's .npz."""
    from ctr_recommendation_tpu.cli.train import run_training
    from ctr_recommendation_tpu.config import microlens_experiment
    from ctr_recommendation_tpu.config.loader import microlens_features
    from ctr_recommendation_tpu.data import write_synthetic_dataset
    from ctr_recommendation_tpu.training import Trainer
    from ctr_recommendation_tpu_torch.tools import jax_bridge

    tmp = tmp_path_factory.mktemp("evaluate")
    root, ckpt = str(tmp / "data"), str(tmp / "ckpt")
    write_synthetic_dataset(root, num_rows=3000, valid_frac=0.2, test_frac=0.1, num_items=199,
                            num_users=40, max_len=8, mm_dim=24, seed=0)
    exp = microlens_experiment(data_root=root, embedding_dim=16, hidden_units=(32, 16),
                               batch_size=256, epochs=1, max_len=8, use_pallas=False,
                               checkpoint_dir=ckpt, log_every=1000)
    exp = exp.replace(dataset=dataclasses.replace(exp.dataset, features=microlens_features(
        item_vocab=200, cate_vocab=11, max_len=8, mm_dim=24)))
    with contextlib.redirect_stdout(io.StringIO()):
        assert run_training(exp) == 0
    trainer = Trainer(exp, steps_per_epoch=1, log_fn=lambda s: None)
    trainer.load_best()
    weights = str(tmp / "weights.npz")
    jax_bridge.save(weights, jax.device_get(trainer.state.params),
                    jax.device_get(trainer.state.model_state))
    return tmp, root, ckpt, weights


def _served_as(tmp, ckpt, precision) -> str:
    """A copy of the checkpoint whose experiment.json serves at
    ``precision`` through the fused scoring path (the trained fp32 weights
    are the same)."""
    out = tmp / f"ckpt_{precision}"
    if not out.exists():
        shutil.copytree(ckpt, out)
        exp_json = out / "experiment.json"
        cfg = json.loads(exp_json.read_text())
        cfg["train"]["compute_dtype"] = precision
        cfg["model"]["tower_dtype"] = "float32" if precision == "float32" else "compute"
        cfg["model"]["use_pallas"] = True
        exp_json.write_text(json.dumps(cfg))
    return str(out)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, [ln for ln in out.getvalue().splitlines() if ln.startswith("[")], err.getvalue()


def _both(jax_checkpoint, precision, *flags):
    from ctr_recommendation_tpu.cli.evaluate import main as jax_main
    from ctr_recommendation_tpu_torch.cli.evaluate import main as port_main

    tmp, root, ckpt, weights = jax_checkpoint
    args = ["--data-root", root, "--checkpoint-dir", _served_as(tmp, ckpt, precision),
            "--batch-size", "128", *flags]
    return (_run(jax_main, args),
            _run(port_main, [*args, "--weights", weights, "--device", "cpu"]))


EVAL_LINE = re.compile(
    r"\[eval\] rows=(\d+) AUC=(\d\.\d{6}) logloss=(\d\.\d{6}) gAUC\[user_id\]=(\d\.\d{6})")

# fp32: both score with fp32 operands; the sums run in another order, far
# below the six printed decimals. bf16: each side rounds the trunk and tower
# to bf16 at its own points (XLA fuses; the port rounds where its kernels
# do), so a probability may move by a few bf16 ulps (the Predictor's bar is
# 2e-2 elementwise); that reorders only near-tied pairs in AUC and gAUC and
# moves logloss by the mean relative change of p.
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-3}


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_evaluate_cli_matches_the_jax_cli(jax_checkpoint, precision):
    (j_rc, j_lines, _), (p_rc, p_lines, _) = _both(
        jax_checkpoint, precision, "--gauc-col", "user_id")
    assert j_rc == p_rc == 0
    assert p_lines[0].startswith("[data] ") and p_lines[0] == j_lines[0]
    want = EVAL_LINE.fullmatch(j_lines[-1]).groups()
    got = EVAL_LINE.fullmatch(p_lines[-1]).groups()
    assert got[0] == want[0] == "600"
    for name, g, w in zip(("AUC", "logloss", "gAUC"), got[1:], want[1:]):
        assert abs(float(g) - float(w)) <= TOLERANCE[precision], (name, g, w)
    assert 0.5 < float(got[1]) < 1.0 and 0.5 < float(got[3]) < 1.0


def test_eval_line_format_without_gauc(jax_checkpoint):
    (j_rc, j_lines, _), (p_rc, p_lines, _) = _both(jax_checkpoint, "float32")
    assert j_rc == p_rc == 0
    fmt = re.compile(r"\[eval\] rows=600 AUC=\d\.\d{6} logloss=\d\.\d{6}")
    assert fmt.fullmatch(j_lines[-1]) and fmt.fullmatch(p_lines[-1])
    assert p_lines[-1] == j_lines[-1]


@pytest.mark.parametrize("flags, message", [
    (["--split", "test"], "has no 'label' column — evaluation needs a labeled split"),
    (["--gauc-col", "nope"], "--gauc-col 'nope' is not a column of"),
], ids=["unlabeled-split", "unknown-gauc-col"])
def test_evaluate_cli_exits_2_as_the_jax_cli(jax_checkpoint, flags, message):
    (j_rc, j_lines, j_err), (p_rc, p_lines, p_err) = _both(jax_checkpoint, "float32", *flags)
    assert j_rc == p_rc == 2
    assert message in p_err and p_err == j_err
    assert not p_lines  # before any scoring: not even the [data] line


def test_evaluate_function_returns_the_cli_numbers(jax_checkpoint):
    """``evaluate`` (what chip_smoke drives from numpy tables) gives what
    the CLI prints, and its AUC is ``auc`` over its own probabilities."""
    from ctr_recommendation_tpu_torch.cli.evaluate import eval_line, evaluate
    from ctr_recommendation_tpu_torch.config import serialize
    from ctr_recommendation_tpu_torch.data import ItemStore, load_split
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.inference import Predictor
    from ctr_recommendation_tpu_torch.tools import jax_bridge
    from ctr_recommendation_tpu_torch.training.metrics import auc

    tmp, root, ckpt, weights = jax_checkpoint
    exp = serialize.load(_served_as(tmp, ckpt, "float32") + "/experiment.json")
    fm = build_feature_map(exp.dataset)
    table = load_split(root + "/valid.parquet", fm)
    pred = Predictor(exp, *jax_bridge.params_from_jax(*jax_bridge.load(weights), fm, exp.model),
                     item_store=ItemStore.from_parquet(root + "/item_info.parquet"), device="cpu")
    res = evaluate(pred, table, batch_size=128, gauc_col="user_id")
    assert res["rows"] == 600 and res["probs"].shape == (600,)
    assert res["auc"] == auc(torch.from_numpy(table.columns["label"]),
                             torch.from_numpy(res["probs"])).item()
    _, (_, p_lines, _) = _both(jax_checkpoint, "float32", "--gauc-col", "user_id")
    assert eval_line(res, "user_id") == p_lines[-1]
