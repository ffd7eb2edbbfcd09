"""The port's data-parallel Trainer across two torch.distributed ranks (gloo
on the CPU) against one process: the JAX package's ``Trainer`` and the
port's own.

One spawn of two ranks (``tests/_torch_dp_worker.py``, 120 s limit, killed
past it) runs every case of this file; each test reads its case's outputs.
Batches and weights come from seeded numpy and the JAX init, moved across
with ``tools/jax_bridge``. Tolerances:

* the 2-rank step (64 rows, 32 a rank; fp32, dropout 0, BatchNorm on)
  against the JAX single-process ``_train_step`` and ``jax.value_and_grad``
  on the 64 rows: the loss to rtol 1e-5; every gradient, and the item table
  (with its Adam state) after the update, to rtol 1e-4 / atol 1e-5 of the
  leaf's largest magnitude (at least 1), the bar of
  ``tests/test_torch_training.py::test_train_step_loss_and_gradients_match_jax``;
  dense tables and ``adam`` sparse tables under both strategies;
* the 2-rank step with dropout (net 0.2; sasrec_fibinet also attn 0.1, on
  the fused encoder's path and the plain one) and a weighted batch, against
  the port's 1-rank step: the same masks are drawn, so only the order of
  fp32 sums differs: the same bar, and the BatchNorm running statistics to
  1e-5;
* BatchNorm alone, weighted and not: outputs, input and parameter
  gradients, running statistics, 2 ranks against 1, to 1e-5;
* every rank's parameters after the step bit for bit rank 0's;
* ``fit_on_device`` over 2 ranks against 1 rank: per-epoch loss within
  1e-4, AUC and logloss within 1e-3;
* the train CLI over 2 ranks with ``--stream`` and row groups that divide
  unevenly between them (the counterpart of
  ``tests/test_distributed.py::test_two_process_streaming_cli_uneven_row_groups``):
  both ranks run the common step count, rank 0 alone writes the one
  checkpoint directory, whose export serves with rank 0's best AUC (2e-3).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.parallel.mesh import single_device_mesh
from ctr_recommendation_tpu.training import Trainer as JaxTrainer
from ctr_recommendation_tpu.training import bce_with_logits as jax_bce
from ctr_recommendation_tpu.training import sparse as jax_sparse
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.data import synthetic_splits
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm
from ctr_recommendation_tpu_torch.tools import jax_bridge
from tests import _torch_dp_worker as worker
from tests.conftest import make_batch

torch.set_num_threads(2)

N = 64  # the global batch, 32 rows a rank
GATHERED = 0.0  # GATHERED_MIN_VOCAB_RATIO that puts every table on the gathered strategy


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _exp(tiny_experiment, table_opt="dense", model="mm_fibinet", dropout=False):
    cfg = dataclasses.replace(
        tiny_experiment.model, model=model, use_pallas=True, tower_dtype="float32",
        net_dropout=0.2 if dropout else 0.0, attn_dropout=0.1 if dropout else 0.0)
    tc = dataclasses.replace(
        tiny_experiment.train, table_optimizer=table_opt, compute_dtype="float32",
        async_checkpointing=False, tensorboard=False)
    return tiny_experiment.replace(model=cfg, train=tc)


def _batch(seed, weighted=False):
    rng = np.random.default_rng(seed)
    b = make_batch(rng, N)
    b["label"] = (rng.random(N) < 0.5).astype(np.float32)
    if weighted:  # a padded tail in each rank's half
        w = np.ones(N, np.float32)
        w[N // 2 - 5 : N // 2] = 0.0
        w[-3:] = 0.0
        b["__weight__"] = w
    return b


# (name, table optimizer, model, dropout, weighted batch, forced strategy)
JAX_CASES = [("dense", "dense", None), ("adam", "adam", None),
             ("adam_gathered", "adam", GATHERED)]
PORT_CASES = [("drop_mm", "mm_fibinet", True), ("drop_sasrec", "sasrec_fibinet", True),
              ("drop_sasrec_jnp", "sasrec_fibinet", False)]


@pytest.fixture(scope="module")
def ranks(tiny_experiment, tmp_path_factory):
    """Write every case's inputs, run the two ranks once, and keep what the
    tests compare against: the JAX trainers (fresh, before any step) and
    the port's experiments."""
    root = str(tmp_path_factory.mktemp("dp"))
    cases, refs = [], {}
    for name, table_opt, ratio in JAX_CASES:
        exp = _exp(tiny_experiment, table_opt)
        exp = exp.replace(train=dataclasses.replace(
            exp.train, checkpoint_dir=os.path.join(root, f"jax_{name}")))
        jt = JaxTrainer(exp, mesh=single_device_mesh(), total_steps=10, log_fn=lambda s: None)
        pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
        params, state = jax_bridge.params_from_jax(
            np_tree(jt.state.params), np_tree(jt.state.model_state),
            pt_build_fm(pexp.dataset), pexp.model)
        weights = os.path.join(root, f"{name}.npz")
        jax_bridge.save(weights, params, state)
        batch = os.path.join(root, f"{name}_batch.npz")
        np.savez(batch, **_batch(5))
        cases.append({"kind": "step", "name": name, "experiment": pt_serialize.to_json(pexp),
                      "weights": weights, "batch": batch, "gathered_ratio": ratio,
                      "ckpt": os.path.join(root, f"ckpt_{name}_")})
        refs[name] = (exp, jt)
    for name, model, use_pallas in PORT_CASES:
        exp = _exp(tiny_experiment, model=model, dropout=True)
        pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
        pexp = pexp.replace(model=dataclasses.replace(pexp.model, use_pallas=use_pallas))
        batch = os.path.join(root, f"{name}_batch.npz")
        np.savez(batch, **_batch(6, weighted=True))
        cases.append({"kind": "step", "name": name, "experiment": pt_serialize.to_json(pexp),
                      "weights": None, "batch": batch, "gathered_ratio": None,
                      "ckpt": os.path.join(root, f"ckpt_{name}_")})
        refs[name] = pexp
    for weighted in (False, True):
        cases.append({"kind": "bn", "name": f"bn_{weighted}", "weighted": weighted})
    # fit_on_device: 1024 train rows, a global batch of 64, 2 epochs
    train, valid, store = synthetic_splits(1024, 256, num_items=199, max_len=8, mm_dim=24,
                                           num_users=100, seed=3)
    ids = np.flatnonzero(store.known_mask)
    splits = os.path.join(root, "splits.npz")
    np.savez(splits, item_ids=ids, item_emb=store.emb[ids],
             **{f"train/{k}": v for k, v in train.columns.items()},
             **{f"valid/{k}": v for k, v in valid.columns.items()})
    fit_exp = pt_serialize.from_json(jax_serialize.to_json(tiny_experiment))
    fit_exp = fit_exp.replace(
        model=dataclasses.replace(fit_exp.model, tower_dtype="float32"),
        train=dataclasses.replace(fit_exp.train, epochs=2, eval_batch_size=128,
                                  log_every=10_000, compute_dtype="float32"))
    cases.append({"kind": "fit", "name": "fit", "experiment": pt_serialize.to_json(fit_exp),
                  "splits": splits, "ckpt": os.path.join(root, "ckpt_fit")})
    refs["fit"] = (pt_serialize.to_json(fit_exp), splits)
    # the train CLI, --stream over row groups of 400 rows: ~600 vs ~400 a rank
    import pyarrow.parquet as pq

    from ctr_recommendation_tpu_torch.data import write_synthetic_dataset

    data = os.path.join(root, "data")
    write_synthetic_dataset(data, num_rows=1334, num_items=200, seed=5)
    train_path = os.path.join(data, "train.parquet")
    pq.write_table(pq.read_table(train_path), train_path, row_group_size=400)
    assert pq.ParquetFile(train_path).metadata.num_row_groups == 3
    ckpt = os.path.join(root, "ckpt_cli")
    cases.append({"kind": "cli", "name": "cli", "argv": [
        "--synthetic", data, "--synthetic-items", "200", "--epochs", "2",
        "--embedding-dim", "16", "--batch-size", "100", "--checkpoint-dir", ckpt,
        "--device", "cpu", "--stream"]})
    refs["cli"] = (data, ckpt)
    outs = worker.run_ranks(cases, os.path.join(root, "out"))
    return {"out": os.path.join(root, "out"), "root": root, "refs": refs, "logs": outs}


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=err_msg)


def _replicas_agree(ranks, name):
    r0, r1 = (worker.load(ranks["out"], name, r) for r in (0, 1))
    assert sorted(r0) == sorted(r1)
    for k in r0:
        if k.startswith(("param/", "state/", "topt/")) or k == "loss":
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=f"{name}: {k}")
    return r0


@pytest.mark.parametrize("name", [c[0] for c in JAX_CASES])
def test_two_rank_step_matches_the_jax_single_process_step(ranks, monkeypatch, name):
    """The counterpart of tests/test_distributed.py::
    test_two_process_trainer_step_matches_single_process, held closer: the
    loss, every gradient and the updated item table (with its Adam moments
    under the sparse optimizer)."""
    exp, jt = ranks["refs"][name]
    ratio = dict((c[0], c[2]) for c in JAX_CASES)[name]
    if ratio is not None:
        monkeypatch.setattr(jax_sparse, "GATHERED_MIN_VOCAB_RATIO", ratio)
    got = _replicas_agree(ranks, name)
    batch = _batch(5)
    if name == "dense":  # every gradient, from the JAX init's parameters
        feats = {k: v for k, v in batch.items() if k != "label"}

        def loss_fn(p):
            logits, _ = jt.module.apply(
                p, jt.state.model_state, jt.fm, exp.model, feats, train=True,
                rng=jax.random.key(0), compute_dtype=jnp.float32)
            return jax_bce(logits, jnp.asarray(batch["label"]))

        grads = jax_bridge.flatten(np_tree(jax.grad(loss_fn)(jt.state.params)))
        keys = [k for k in got if k.startswith("grad/")]
        assert len(keys) == len(grads)
        for k in keys:
            _close(got[k], grads[k[len("grad/"):]], k)
    state, metrics = jt._train_step(jt.state, jt.put_batch(batch), jax.random.key(0))
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=1e-5)
    _close(got["param/trunk/tables/item_id"], state.params["trunk"]["tables"]["item_id"],
           "item table")
    if name != "dense":
        for k in ("mu", "nu"):
            _close(got[f"topt/item_id/{k}"], state.table_opt_state["item_id"][k], k)


@pytest.mark.parametrize("name", [c[0] for c in PORT_CASES])
def test_two_rank_step_with_dropout_matches_one_rank(ranks, name):
    """Dropout 0.2 in the tower (and 0.1 in the encoder, fused and plain),
    weighted rows: the ranks draw the global batch's masks."""
    pexp = ranks["refs"][name]
    got = _replicas_agree(ranks, name)
    want = worker.port_step(pt_serialize.to_json(pexp), None,
                            dict(np.load(os.path.join(ranks["root"], f"{name}_batch.npz"))),
                            ckpt=os.path.join(ranks["root"], f"ckpt1_{name}"))
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for k in want:
        if k.startswith("grad/"):
            _close(got[k], want[k], k)
        elif k.startswith("state/"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    _close(got["param/trunk/tables/item_id"], want["param/trunk/tables/item_id"])
    # the masks matter: without dropout the loss differs
    assert got["grad/mlp/out/w"].std() > 0


@pytest.mark.parametrize("weighted", [False, True])
def test_batch_norm_statistics_and_gradients_are_global(ranks, weighted):
    want = worker.port_bn(weighted)
    r0, r1 = (worker.load(ranks["out"], f"bn_{weighted}", r) for r in (0, 1))
    for k in want:
        if k in ("out", "dx"):  # each rank holds its rows
            got = np.concatenate([r0[k], r1[k]])
        else:
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
            got = r0[k]
        np.testing.assert_allclose(got, want[k], rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(want[k]).max()), err_msg=k)


def test_fit_on_device_two_ranks_matches_one(ranks, tmp_path):
    """batch_size is the global batch: 2 ranks of 32 rows take the steps of
    one process of 64, with its permutation and dropout masks."""
    experiment, splits = ranks["refs"]["fit"]
    want = worker.port_fit(experiment, splits, str(tmp_path / "one"))
    got = worker.load(ranks["out"], "fit")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert abs(g["train_loss"] - w["train_loss"]) < 1e-4, (g, w)
        assert abs(g["auc"] - w["auc"]) < 1e-3, (g, w)
        assert abs(g["logloss"] - w["logloss"]) < 1e-3, (g, w)
    metrics = ("epoch", "train_loss", "auc", "logloss")
    for g, g1 in zip(got, worker.load(ranks["out"], "fit", 1)):  # rank 0's metrics on both
        assert [g[k] for k in metrics] == [g1[k] for k in metrics]


def test_train_cli_two_ranks_stream_uneven_row_groups(ranks, capsys):
    """Both ranks run the common step count (4 steps of 2 x 100 rows an
    epoch, not the 6 the larger shard holds), one checkpoint directory is
    written, from rank 0, and its export serves with rank 0's AUC. Without
    the process group each rank trained the whole split alone."""
    from ctr_recommendation_tpu_torch.cli.evaluate import main as evaluate_main
    from ctr_recommendation_tpu_torch.config import serialize

    for r in (0, 1):
        assert worker.load(ranks["out"], "cli", r) == {"rc": 0}
        assert ranks["logs"][r].count("(800/") == 2, ranks["logs"][r]
    data, ckpt = ranks["refs"]["cli"]
    assert sorted(os.listdir(ckpt)) == [
        "best", "ckpt_1.pt", "ckpt_2.pt", "experiment.json", "metrics.csv", "tb"]
    assert len(os.listdir(os.path.join(ckpt, "tb"))) == 1  # rank 0's events alone
    exp = serialize.load(os.path.join(ckpt, "experiment.json"))
    assert exp.train.batch_size == 100
    import csv

    with open(os.path.join(ckpt, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(float(r["epoch"])) for r in rows] == [1, 2]
    best = max(float(r["auc"]) for r in rows)
    capsys.readouterr()
    assert evaluate_main(["--data-root", data, "--checkpoint-dir", ckpt, "--device", "cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[eval]")][0]
    served = float(line.split("AUC=")[1].split()[0])
    assert abs(served - best) < 2e-3


def test_encoder_masks_count_tokens_from_token0():
    """A rank's encoder dropout (token0 = its first global row x S) draws
    the global batch's mask rows, plain and through the kernels' plain
    versions alike; the counter wraps at 2^32 as the kernels' uint32 does."""
    from ctr_recommendation_tpu_torch.ops.cuda import encoder_blocks as blocks
    from ctr_recommendation_tpu_torch.ops.cuda import sasrec_encoder as enc

    seed = torch.tensor([0x1234_5678_9ABC], dtype=torch.int64)
    full = blocks.dropout_mask(seed, 40 * 8, 32, 0, 1, 0.3)
    for row0 in (0, 17, 23):
        part = blocks.dropout_mask(seed, 17 * 8, 32, 0, 1, 0.3, token0=row0 * 8)
        assert torch.equal(part, full[row0 * 8 : row0 * 8 + 17 * 8])
    wrapped = blocks.dropout_mask(seed, 16, 32, 1, 0, 0.3, token0=(1 << 32) - 8)
    assert torch.equal(wrapped[8:], blocks.dropout_mask(seed, 8, 32, 1, 0, 0.3))
    # the encoder forward and backward on the second half of a batch
    rng = np.random.default_rng(0)
    b, s, e, h = 6, 8, 32, 2
    x = torch.from_numpy(rng.standard_normal((b, s, e)).astype(np.float32))
    amask = torch.zeros(b, s)
    amask[:, 6:] = -1e9
    g = torch.from_numpy(rng.standard_normal((b, s, e)).astype(np.float32))
    ws = []
    for name in enc.WEIGHT_NAMES:
        shape = {"qkv_w": (1, e, 3 * e), "qkv_b": (1, 3 * e), "proj_w": (1, e, e),
                 "ffn1_w": (1, e, 4 * e), "ffn1_b": (1, 4 * e), "ffn2_w": (1, 4 * e, e)}.get(
            name, (1, e))
        ws.append(torch.from_numpy((rng.standard_normal(shape) * 0.2).astype(np.float32)))
    kw = dict(num_heads=h, seed=seed, rate=0.25)
    fwd = enc.encode_fwd(x, amask, *ws, **kw)
    half = enc.encode_fwd(x[3:], amask[3:], *ws, **kw, token0=3 * s)
    torch.testing.assert_close(half, fwd[3:], rtol=1e-6, atol=1e-6)
    assert not torch.allclose(enc.encode_fwd(x[3:], amask[3:], *ws, **kw), fwd[3:])
    dx, *_ = enc.encode_bwd(g, x, amask, *ws, **kw)
    dx_half, *_ = enc.encode_bwd(g[3:], x[3:], amask[3:], *ws, **kw, token0=3 * s)
    torch.testing.assert_close(dx_half, dx[3:], rtol=1e-5, atol=1e-6)
