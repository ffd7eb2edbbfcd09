"""The port's training slice against the JAX package's, on the CPU.

Inputs come from seeded numpy (or from the JAX package's own init, moved
across with tools/jax_bridge) and go through the JAX function and its
counterpart in the port:

* masked train-mode BatchNorm (outputs and running stats): fp32 to 1e-5;
  bf16 outputs to the bar of the eval tower's test in test_torch_ops.py
  (atol 5e-2, rtol 2e-2: matmuls, normalization and ReLU all round in bf16,
  at points that differ between XLA and PyTorch), bf16 running stats to
  2e-2 (fp32 statistics of bf16-rounded activations);
* one MM-FiBiNET train step (logits, loss and every parameter gradient,
  dropout 0, fp32, with and without the fused interaction, and at E=256
  with a (1024, 512) tower): rtol 1e-4 / atol 1e-5 of each leaf's largest
  gradient (summation order only);
* schedules (rtol 1e-5 and atol 1e-6 x lr: optax computes in fp32, the
  port in float64, and cos(pi pct) + 1 cancels near the end of a phase),
  five optimizer updates on the same gradients (1e-5), BCE, AUC and logloss;
* the slice as a whole: ``Trainer.fit_on_device`` against the JAX one from
  the same initial weights (fp32, no shuffling, no dropout, the fused
  interaction on both sides): per-epoch loss within 1e-3, AUC within 5e-3;
* resume, checkpoints and the CLIs.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.config.schema import TrainConfig as JaxTrainConfig
from ctr_recommendation_tpu.data import ItemStore as JaxItemStore
from ctr_recommendation_tpu.data.parquet import TableData as JaxTableData
from ctr_recommendation_tpu.models import build_model as jax_build_model
from ctr_recommendation_tpu.ops import mlp as jax_mlp
from ctr_recommendation_tpu.parallel.mesh import single_device_mesh
from ctr_recommendation_tpu.training import Trainer as JaxTrainer
from ctr_recommendation_tpu.training import bce_with_logits as jax_bce
from ctr_recommendation_tpu.training import metrics as jax_metrics
from ctr_recommendation_tpu.training.optim import make_optimizer as jax_make_optimizer
from ctr_recommendation_tpu.training.optim import make_schedule as jax_make_schedule
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.config.schema import TrainConfig
from ctr_recommendation_tpu_torch.data import ItemStore, TableData, synthetic_splits
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm
from ctr_recommendation_tpu_torch.inference import Predictor
from ctr_recommendation_tpu_torch.models import fibinet as pt_fibinet
from ctr_recommendation_tpu_torch.ops import mlp as pt_mlp
from ctr_recommendation_tpu_torch.tools import jax_bridge
from ctr_recommendation_tpu_torch.training import Trainer, bce_with_logits
from ctr_recommendation_tpu_torch.training import metrics as pt_metrics
from ctr_recommendation_tpu_torch.training.checkpoint import CheckpointManager
from ctr_recommendation_tpu_torch.training.optim import make_optimizer, make_schedule
from ctr_recommendation_tpu_torch.utils.tree import tree_map
from tests.conftest import make_batch

torch.set_num_threads(2)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def pt_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


# ---------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_batch_norm_matches_jax(dtype, masked):
    rng = np.random.default_rng(0)
    params, state = jax_mlp.init(jax.random.key(0), 48, [32, 16], batch_norm=True)
    params, state = np_tree(params), np_tree(state)
    for st in state["layers"]:
        st["bn_mean"] = rng.normal(0, 0.3, st["bn_mean"].shape).astype(np.float32)
        st["bn_var"] = rng.uniform(0.5, 2.0, st["bn_var"].shape).astype(np.float32)
    x = rng.standard_normal((40, 48)).astype(np.float32)
    weight = (rng.random(40) < 0.7).astype(np.float32) if masked else None
    want, want_st = jax_mlp.apply(
        params, state, jnp.asarray(x, dtype), train=True,
        weight=None if weight is None else jnp.asarray(weight),
    )
    got, got_st = pt_mlp.apply(
        pt_tree(params), pt_tree(state), torch.from_numpy(x).to(getattr(torch, dtype)),
        train=True, weight=None if weight is None else torch.from_numpy(weight),
    )
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want, np.float32)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=5e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    for g, w in zip(got_st["layers"], want_st["layers"]):
        for k in ("bn_mean", "bn_var"):
            assert g[k].dtype == torch.float32
            # statistics are fp32 in both; bf16 only reaches them through h
            st_tol = 1e-5 if dtype == "float32" else 2e-2
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=st_tol, atol=st_tol)


def test_dropout_is_seeded_scaled_and_train_only():
    params, state = pt_mlp.init(torch.Generator().manual_seed(0), 32, [64], batch_norm=False)
    x = torch.randn(512, 32, generator=torch.Generator().manual_seed(1))
    run = lambda seed: pt_mlp.apply(  # noqa: E731
        params, state, x, train=True, dropout_rate=0.25,
        generator=torch.Generator().manual_seed(seed))[0]
    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    evaluated = pt_mlp.apply(params, state, x, dropout_rate=0.25)[0]
    torch.testing.assert_close(
        evaluated, pt_mlp.apply(params, state, x)[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        pt_mlp.apply(params, state, x, train=True, dropout_rate=0.25)
    # the hidden activation keeps its mean under inverted dropout
    hidden = {"layers": params["layers"]}
    kept = pt_mlp.apply(hidden, state, x, train=True, dropout_rate=0.25,
                        generator=torch.Generator().manual_seed(5))[0]
    full = pt_mlp.apply(hidden, state, x)[0]
    zeros = lambda t: (t == 0).float().mean().item()  # noqa: E731
    # zero after dropout: dropped (1/4) or kept and already zero after ReLU
    assert abs(zeros(kept) - (0.25 + 0.75 * zeros(full))) < 0.02
    assert abs(kept.mean().item() / full.mean().item() - 1.0) < 0.05


# ---------------------------------------------------------------- one step
def _bridged(tiny_experiment, tiny_feature_map, use_pallas, **model_kw):
    cfg = dataclasses.replace(
        tiny_experiment.model, use_pallas=use_pallas, net_dropout=0.0, tower_dtype="float32",
        **model_kw,
    )
    train = dataclasses.replace(tiny_experiment.train, compute_dtype="float32")
    exp = tiny_experiment.replace(model=cfg, train=train)
    module, params, state = jax_build_model(tiny_feature_map, cfg, jax.random.key(0))
    pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
    pparams, pstate = jax_bridge.params_from_jax(
        np_tree(params), np_tree(state), pt_build_fm(pexp.dataset), pexp.model
    )
    return exp, module, params, state, pexp, pparams, pstate


@pytest.mark.parametrize("use_pallas, model_kw", [
    pytest.param(True, {}, id="True"),
    pytest.param(False, {}, id="False"),
    # the recipe sweep's emb_256_tower1024: E=256 through the interaction
    # kernels' wide path and a (1024, 512) tower
    pytest.param(True, {"embedding_dim": 256, "hidden_units": (1024, 512)},
                 id="True-E256-1024x512"),
])
def test_train_step_loss_and_gradients_match_jax(
        tiny_experiment, tiny_feature_map, use_pallas, model_kw):
    exp, module, params, state, pexp, pparams, pstate = _bridged(
        tiny_experiment, tiny_feature_map, use_pallas, **model_kw)
    rng = np.random.default_rng(2)
    batch = make_batch(rng, 48)
    labels = (rng.random(48) < 0.4).astype(np.float32)
    weight = np.ones(48, np.float32)
    weight[-5:] = 0.0  # a padded tail: left out of the loss and BatchNorm

    def loss_fn(p):
        logits, new_state = module.apply(
            p, state, tiny_feature_map, exp.model, batch, train=True,
            rng=jax.random.key(9), compute_dtype=jnp.float32, weight=jnp.asarray(weight),
        )
        return jax_bce(logits, jnp.asarray(labels), jnp.asarray(weight)), (new_state, logits)

    (want_loss, (want_state, want_logits)), want_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)

    leaves = list(jax_bridge.flatten(tree_map(lambda t: t.requires_grad_(), pparams)).values())
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, got_state = pt_fibinet.apply(
        pparams, pstate, pt_build_fm(pexp.dataset), pexp.model, tbatch, train=True,
        compute_dtype=torch.float32, weight=torch.from_numpy(weight),
    )
    loss = bce_with_logits(logits, torch.from_numpy(labels), torch.from_numpy(weight))
    grads = torch.autograd.grad(loss, leaves)

    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want_logits).max()))
    flat_want = jax_bridge.flatten(np_tree(want_grads))
    flat_got = jax_bridge.flatten(pparams)  # the order of ``leaves``
    assert len(grads) == len(flat_want) == len(flat_got)
    for path, g in zip(flat_got, grads):
        w = flat_want[path]
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=path)
    for g, w in zip(got_state["mlp"]["layers"], want_state["mlp"]["layers"]):
        for k in ("bn_mean", "bn_var"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=1e-5, atol=1e-6)


def test_bce_matches_optax():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal(64) * 6).astype(np.float32)
    labels = (rng.random(64) < 0.5).astype(np.float32)
    weight = (rng.random(64) < 0.8).astype(np.float32)
    for w in (None, weight, np.zeros(64, np.float32)):
        want = jax_bce(jnp.asarray(logits), jnp.asarray(labels),
                       None if w is None else jnp.asarray(w))
        got = bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels),
                              None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------- schedule, optimizer
@pytest.mark.parametrize("kind", ["onecycle", "cosine", "constant"])
@pytest.mark.parametrize("total", [1, 3, 4, 10, 1000])
def test_schedule_matches_optax(kind, total):
    cfg = dict(lr_schedule=kind, learning_rate=2e-3)
    want = jax_make_schedule(JaxTrainConfig(**cfg), total)
    got = make_schedule(TrainConfig(**cfg), total)
    counts = sorted(set(range(min(total, 12) + 3)) | {total // 3, total - 1, total, total + 5})
    for c in counts:
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-5, atol=2e-9,
                                   err_msg=f"count {c}")


@pytest.mark.parametrize("kind", ["adam", "adamw", "adagrad"])
def test_optimizer_matches_optax(kind):
    rng = np.random.default_rng(4)
    cfg = dict(optimizer=kind, learning_rate=1e-2, weight_decay=1e-2, grad_clip_norm=10.0)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    # every other step large enough that the global-norm clip engages
    grads = [[(rng.standard_normal(s) * (8.0 if k % 2 else 0.5)).astype(np.float32)
              for s in shapes] for k in range(5)]
    tx, _ = jax_make_optimizer(JaxTrainConfig(**cfg), 50)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    opt, _ = make_optimizer(TrainConfig(**cfg), 50)
    tp = [torch.from_numpy(p.copy()) for p in params]
    state = opt.init(tp)
    for step in range(5):
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads[step]], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update([torch.from_numpy(g.copy()) for g in grads[step]], state, tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6,
                                       err_msg=f"update {step}")
    assert state["count"] == 5


# ----------------------------------------------------------------- metrics
@pytest.mark.parametrize("case", ["ties", "weights", "single_class", "all_masked"])
def test_auc_and_logloss_match_jax(case):
    rng = np.random.default_rng(5)
    n = 300
    labels = (rng.random(n) < 0.3).astype(np.float32)
    scores = rng.random(n).astype(np.float32)
    weight = None
    if case == "ties":
        scores = np.round(scores * 8) / 8  # many tied scores across classes
    elif case == "weights":
        weight = (rng.random(n) < 0.6).astype(np.float32)
    elif case == "single_class":
        labels = np.ones(n, np.float32)
    else:
        weight = np.zeros(n, np.float32)
    jw = None if weight is None else jnp.asarray(weight)
    tw = None if weight is None else torch.from_numpy(weight)
    want_auc = float(jax_metrics.auc(jnp.asarray(labels), jnp.asarray(scores), jw))
    got_auc = pt_metrics.auc(torch.from_numpy(labels), torch.from_numpy(scores), tw).item()
    np.testing.assert_allclose(got_auc, want_auc, rtol=1e-6, atol=1e-6)
    if case == "single_class":
        assert got_auc == 0.5
    want_ll = float(jax_metrics.logloss(jnp.asarray(labels), jnp.asarray(scores), jw))
    got_ll = pt_metrics.logloss(torch.from_numpy(labels), torch.from_numpy(scores), tw).item()
    np.testing.assert_allclose(got_ll, want_ll, rtol=1e-6, atol=1e-7)
    hp, hn = jax_metrics.binned_auc_update(
        jnp.zeros(64), jnp.zeros(64), jnp.asarray(labels), jnp.asarray(scores), jw, num_bins=64)
    thp, thn = pt_metrics.binned_auc_update(
        torch.zeros(64), torch.zeros(64), torch.from_numpy(labels), torch.from_numpy(scores),
        tw, num_bins=64)
    np.testing.assert_allclose(thp.numpy(), np.asarray(hp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(thn.numpy(), np.asarray(hn), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        pt_metrics.binned_auc_finalize(thp, thn).item(),
        float(jax_metrics.binned_auc_finalize(hp, hn)), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- the slice as whole
def _synthetic_split(n_train, n_valid, seed=0):
    """Tiny high-signal splits in the tiny experiment's schema (item vocab
    200, max_len 8, mm_dim 24): (train cols, valid cols, item ids, item
    vectors), for the JAX and the port's trainers alike."""
    train, valid, store = synthetic_splits(
        n_train, n_valid, num_items=199, max_len=8, mm_dim=24, num_users=100, seed=seed)
    ids = np.flatnonzero(store.known_mask)
    return train.columns, valid.columns, ids, store.emb[ids]


def _exp(tiny_experiment, tmp, **train_kw):
    cfg = dataclasses.replace(
        tiny_experiment.model, use_pallas=True, net_dropout=0.0, tower_dtype="float32"
    )
    train = dataclasses.replace(
        tiny_experiment.train, compute_dtype="float32", shuffle=False, epochs=2,
        checkpoint_dir=str(tmp), eval_batch_size=256, log_every=10_000,
        async_checkpointing=False, tensorboard=False, **train_kw,
    )
    return tiny_experiment.replace(model=cfg, train=train)


def test_fit_on_device_matches_jax(tiny_experiment, tmp_path):
    train, valid, ids, emb = _synthetic_split(1024, 512)
    exp = _exp(tiny_experiment, tmp_path / "jax")
    spe = 1024 // exp.train.batch_size
    jt = JaxTrainer(exp, mesh=single_device_mesh(), steps_per_epoch=spe,
                    item_store=JaxItemStore.from_arrays(ids, emb), log_fn=lambda s: None)
    pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
    pexp = pexp.replace(train=dataclasses.replace(pexp.train, checkpoint_dir=str(tmp_path / "pt")))
    pparams, pstate = jax_bridge.params_from_jax(
        np_tree(jt.state.params), np_tree(jt.state.model_state),
        pt_build_fm(pexp.dataset), pexp.model)
    pt = Trainer(pexp, steps_per_epoch=spe, item_store=ItemStore.from_arrays(ids, emb),
                 params=pparams, model_state=pstate, device="cpu", log_fn=lambda s: None)

    want = jt.fit_on_device(JaxTableData(train, 1024), JaxTableData(valid, 512))
    got = pt.fit_on_device(TableData(train, 1024), TableData(valid, 512))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert abs(g["train_loss"] - w["train_loss"]) < 1e-3, (g, w)
        assert abs(g["auc"] - w["auc"]) < 5e-3, (g, w)
        assert abs(g["logloss"] - w["logloss"]) < 1e-3, (g, w)
    assert got[-1]["train_loss"] < got[0]["train_loss"]
    assert max(h["auc"] for h in got) > 0.6
    assert pt.state.step == int(jt.state.step) == 2 * spe


def test_resume_equals_an_uninterrupted_run(tiny_experiment, tmp_path):
    train, valid, ids, emb = _synthetic_split(512, 256, seed=1)
    store = ItemStore.from_arrays(ids, emb)
    spe = 512 // 64

    def trainer(epochs, ckpt):
        e = pt_serialize.from_json(jax_serialize.to_json(_exp(tiny_experiment, ckpt)))
        e = e.replace(
            model=dataclasses.replace(e.model, net_dropout=0.2),  # masks must replay too
            train=dataclasses.replace(e.train, epochs=epochs, shuffle=True),
        )
        return Trainer(e, total_steps=3 * spe, item_store=store, device="cpu",
                       log_fn=lambda s: None)

    whole = trainer(3, tmp_path / "whole")
    whole.fit_on_device(TableData(train, 512), TableData(valid, 256))
    first = trainer(2, tmp_path / "cut")
    first.fit_on_device(TableData(train, 512), TableData(valid, 256))
    resumed = trainer(3, tmp_path / "cut")
    hist = resumed.fit_on_device(TableData(train, 512), TableData(valid, 256), resume=True)
    assert len(hist) == 1 and resumed.state.step == 3 * spe
    for a, b in zip(resumed.param_leaves, whole.param_leaves):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert hist[0]["auc"] == whole.history[-1]["auc"]
    with open(tmp_path / "cut" / "metrics.csv") as f:
        assert len(f.read().strip().splitlines()) == 1 + 3  # header + every epoch


def test_checkpoints_keep_the_newest_and_swap_the_best(tmp_path):
    from ctr_recommendation_tpu_torch.training.train_state import TrainState

    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        params = {"w": torch.full((2,), float(step))}
        mgr.save(step, TrainState(step * 10, params, {}, {"count": step}))
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    restored = mgr.restore()
    assert restored["step"] == 30 and restored["params"]["w"].tolist() == [3.0, 3.0]
    assert mgr.best_metric() is None
    mgr.save_best({"w": torch.ones(2)}, {"layers": [{}]}, 0.7, 5)
    mgr.save_best({"w": torch.zeros(2)}, {}, 0.8, 9)
    assert mgr.best_metric() == pytest.approx(0.8)
    params, _ = mgr.restore_best()
    assert params["w"].tolist() == [0.0, 0.0]
    assert sorted(os.listdir(tmp_path / "best")) == ["export.npz", "metric.json"]
    assert json.loads((tmp_path / "best" / "metric.json").read_text())["step"] == 9


def test_best_export_serves_with_the_trainers_auc(tiny_experiment, tmp_path):
    """The trained export through Predictor (fused scoring, folded BN)
    scores the valid split with the trainer's best AUC."""
    train, valid, ids, emb = _synthetic_split(768, 384, seed=2)
    store = ItemStore.from_arrays(ids, emb)
    exp = pt_serialize.from_json(jax_serialize.to_json(_exp(tiny_experiment, tmp_path)))
    tr = Trainer(exp, steps_per_epoch=768 // 64, item_store=store, device="cpu",
                 log_fn=lambda s: None)
    hist = tr.fit_on_device(TableData(train, 768), TableData(valid, 384))
    params, state = jax_bridge.params_from_jax(
        *tr.ckpt.restore_best(), tr.fm, exp.model)
    pred = Predictor(exp, params, state, item_store=store, device="cpu")
    assert pred.use_fused
    probs = pred.score_table(TableData(valid, 384), batch_size=128)
    served = pt_metrics.auc(torch.from_numpy(valid["label"]), torch.from_numpy(probs)).item()
    assert abs(served - max(h["auc"] for h in hist)) < 2e-3
    tr.load_best()
    assert abs(tr.evaluate_table(TableData(valid, 384))["auc"] - served) < 2e-3


# -------------------------------------------------------------------- CLIs
def test_train_then_predict_cli_on_the_ports_own_export(tmp_path):
    from ctr_recommendation_tpu_torch.cli.predict import main as predict_main
    from ctr_recommendation_tpu_torch.cli.train import main as train_main

    data, ckpt, out = tmp_path / "data", tmp_path / "ckpt", tmp_path / "out"
    rc = train_main([
        "--synthetic", str(data), "--synthetic-rows", "3000", "--synthetic-items", "300",
        "--epochs", "1", "--embedding-dim", "16", "--batch-size", "256",
        "--checkpoint-dir", str(ckpt), "--device", "cpu",
    ])
    assert rc == 0
    assert (ckpt / "best" / "export.npz").exists() and (ckpt / "ckpt_1.pt").exists()
    assert (ckpt / "experiment.json").exists() and (ckpt / "metrics.csv").exists()
    rc = predict_main([
        "--data-root", str(data), "--checkpoint-dir", str(ckpt), "--out-dir", str(out),
        "--batch-size", "128", "--device", "cpu",
    ])
    assert rc == 0
    lines = (out / "prediction_fibinet.csv").read_text().splitlines()
    assert lines[0] == "ID,Task2" and len(lines) == 1 + 300
    # --resume picks up after the last epoch
    rc = train_main([
        "--synthetic", str(data), "--synthetic-items", "300", "--epochs", "2",
        "--embedding-dim", "16", "--batch-size", "256", "--checkpoint-dir", str(ckpt),
        "--device", "cpu", "--resume",
    ])
    assert rc == 0 and (ckpt / "ckpt_2.pt").exists()


def test_train_cli_model_parallel_reaches_the_experiments_mesh(monkeypatch, tmp_path):
    """--model-parallel N sets the experiment's mesh (which experiment.json
    records, and the predict, evaluate and serve CLIs replace by a
    replicated one), as the JAX CLI does."""
    from ctr_recommendation_tpu_torch.cli import train as train_cli
    from ctr_recommendation_tpu_torch.config import serialize

    seen = []
    monkeypatch.setattr(train_cli, "run_training", lambda exp, **kw: seen.append(exp) or 0)
    assert train_cli.main(["--data-root", str(tmp_path), "--model-parallel", "2"]) == 0
    assert seen[0].mesh.model_parallel == 2 and seen[0].mesh.data_parallel == -1
    path = str(tmp_path / "experiment.json")
    serialize.save(seen[0], path)
    assert serialize.load(path).mesh.model_parallel == 2


def test_trainer_needs_cuda_unless_told_cpu(monkeypatch, tiny_experiment, tmp_path):
    exp = pt_serialize.from_json(jax_serialize.to_json(_exp(tiny_experiment, tmp_path)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(exp, steps_per_epoch=1)
