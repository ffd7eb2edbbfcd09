"""The port's Trainer with row-sharded tables (``model_parallel`` 2) across
gloo ranks on the CPU, against one process: the port's own step and the
JAX package's ``_train_step`` on a (dp, mp) mesh with
``make_sharded_lookup``.

One spawn a layout (``tests/_torch_dp_worker.py``, 120 s limit, killed past
it): 1 x 2 (two ranks: the steps, ``fit_on_device`` and the train CLI) and
2 x 2 (four ranks: the steps). Batches and weights come from seeded numpy
and the JAX init, moved across with ``tools/jax_bridge``. Each rank holds
its shard of the tables; the tests put the model ranks' shards side by side.
Tolerances:

* one fp32 step (64 global rows, BatchNorm on, weight decay 0 so that the
  gradients after the update are the clipped ones, ``grad_clip_norm`` 0.05
  so that the clip scales them) through the all_to_all and the psum
  exchanges (``small_table_rows`` 0: every table exchanged) against the
  port's one-process step: the loss within 1e-5; at 1 x 2, where each rank
  computes one process's sums, every gradient before and after the clip
  and every parameter after the update within rtol 1e-6 and 1e-6 of the
  leaf's largest magnitude (at least 1); at 2 x 2, where BatchNorm and the
  loss sum 2 x 32 rows in another order, the bar of
  ``tests/test_torch_dp_trainer.py`` (rtol 1e-4, 1e-5 of the largest) on
  the gradients and the tables after the update;
* the all_to_all step against JAX's ``_train_step`` on the same mesh from
  the same weights: the loss within 1e-5, the clipped gradients against
  ``jax.grad`` clipped by optax's rule, the item table after the update;
* with dropout (net 0.2; sasrec_fibinet also attn 0.1) and a weighted
  batch, through the Trainer's default lookup: the same bars against one
  process, which draws the same masks;
* every replicated leaf bit for bit equal across all ranks after the step,
  each shard across its data group;
* ``fit_on_device`` at 1 x 2 against one process: per-epoch loss within
  1e-4, AUC and logloss within 1e-3; world rank 0 alone writes (rank 1's
  directory stays empty), its export and resume point hold whole tables;
* the sparse table optimizers (lazy adam under both strategies, and
  rowwise_adagrad): the same bars, the optimizer state put together from
  the shards too, and every untouched row of each table and of its state
  bit for bit one process's;
* the train CLI at ``--model-parallel 2`` on two ranks, then ``--resume``
  (dense tables, and lazy adam):
  one checkpoint directory whose experiment.json records the mesh, served
  in one process by the predict CLI (one CSV row per test example) and the
  evaluate CLI (AUC within 2e-3 of the fit's best: the Predictor's forward
  is not the trainer's), and restored by a one-process Trainer whose eval
  gives the fit's best AUC within 1e-6.
"""

import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.config.schema import MeshConfig as JaxMeshConfig
from ctr_recommendation_tpu.parallel.embedding import make_sharded_lookup as jax_lookup
from ctr_recommendation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ctr_recommendation_tpu.training import Trainer as JaxTrainer
from ctr_recommendation_tpu.training import bce_with_logits as jax_bce
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.config.schema import MeshConfig
from ctr_recommendation_tpu_torch.data import synthetic_splits
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm
from ctr_recommendation_tpu_torch.tools import jax_bridge
from tests import _torch_dp_worker as worker
from tests.conftest import make_batch

N = 64  # the global batch
CLIP = 0.05
LAYOUTS = [(1, 2), (2, 2)]
# (name, model, dropout, weighted batch, the lookup's keywords: None for the
# Trainer's default, table optimizer, GATHERED_MIN_VOCAB_RATIO: 0.0 puts every
# table on the gathered strategy, 1e12 on masked-dense)
CASES = [
    ("a2a", "mm_fibinet", False, False, {"method": "all_to_all", "small_table_rows": 0},
     "dense", None),
    ("psum", "mm_fibinet", False, False, {"method": "psum", "small_table_rows": 0},
     "dense", None),
    ("drop_mm", "mm_fibinet", True, True, None, "dense", None),
    ("drop_sasrec", "sasrec_fibinet", True, True,
     {"method": "all_to_all", "small_table_rows": 0}, "dense", None),
    ("adam_gathered", "mm_fibinet", True, True, None, "adam", 0.0),
    ("adam_masked", "mm_fibinet", True, True, None, "adam", 1e12),
    ("rowwise_gathered", "mm_fibinet", False, False, None, "rowwise_adagrad", 0.0),
]
DENSE = [c[0] for c in CASES if c[5] == "dense"]
SPARSE = [c[0] for c in CASES if c[5] != "dense"]
TABLES = ("trunk/tables/item_id", "trunk/tables/likes_level")


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _exp(tiny_experiment, model, dropout, table_opt="dense"):
    cfg = dataclasses.replace(
        tiny_experiment.model, model=model, use_pallas=True, tower_dtype="float32",
        net_dropout=0.2 if dropout else 0.0, attn_dropout=0.1 if dropout else 0.0)
    tc = dataclasses.replace(
        tiny_experiment.train, compute_dtype="float32", weight_decay=0.0,
        grad_clip_norm=CLIP, async_checkpointing=False, tensorboard=False,
        table_optimizer=table_opt)
    return tiny_experiment.replace(model=cfg, train=tc)


def _batch(seed, weighted):
    rng = np.random.default_rng(seed)
    b = make_batch(rng, N)
    b["label"] = (rng.random(N) < 0.5).astype(np.float32)
    if weighted:
        w = np.ones(N, np.float32)
        w[10:14] = 0.0
        w[-3:] = 0.0
        b["__weight__"] = w
    return b


def _port_json(exp, mp):
    pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
    return pt_serialize.to_json(pexp.replace(mesh=MeshConfig(model_parallel=mp)))


@pytest.fixture(scope="module")
def spawned(tiny_experiment, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mp"))
    inputs = {}
    for name, model, dropout, weighted, lookup, table_opt, ratio in CASES:
        exp = _exp(tiny_experiment, model, dropout, table_opt)
        weights = None
        if name == "a2a":  # the JAX init, for the comparison with JAX
            jt = JaxTrainer(exp.replace(train=dataclasses.replace(
                exp.train, checkpoint_dir=os.path.join(root, "jax_init"))),
                total_steps=10, log_fn=lambda s: None)
            pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
            params, state = jax_bridge.params_from_jax(
                np_tree(jt.state.params), np_tree(jt.state.model_state),
                pt_build_fm(pexp.dataset), pexp.model)
            weights = os.path.join(root, "a2a_weights.npz")
            jax_bridge.save(weights, params, state)
        batch = os.path.join(root, f"{name}_batch.npz")
        np.savez(batch, **_batch(7, weighted))
        inputs[name] = (exp, weights, batch, lookup, ratio)
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
    from ctr_recommendation_tpu_torch.data import write_synthetic_dataset

    data = os.path.join(root, "data")
    write_synthetic_dataset(data, num_rows=1200, num_items=200, seed=5)
    ckpt = os.path.join(root, "ckpt_cli")
    cli = ["--synthetic", data, "--synthetic-items", "200", "--embedding-dim", "16",
           "--batch-size", "100", "--checkpoint-dir", ckpt, "--device", "cpu",
           "--model-parallel", "2"]
    out, logs = {}, {}
    for dp, mp in LAYOUTS:
        cases = [{"kind": "step", "name": name, "experiment": _port_json(exp, mp),
                  "weights": weights, "batch": batch, "lookup": lookup, "mp": mp,
                  "gathered_ratio": ratio, "ckpt": os.path.join(root, f"ckpt_{dp}x{mp}_{name}_")}
                 for name, (exp, weights, batch, lookup, ratio) in inputs.items()]
        if (dp, mp) == (1, 2):
            cases.append({"kind": "fit", "name": "fit", "mp": mp,
                          "experiment": pt_serialize.to_json(fit_exp.replace(
                              mesh=MeshConfig(model_parallel=mp))),
                          "splits": splits, "ckpt": os.path.join(root, "ckpt_fit_")})
            cases.append({"kind": "cli", "name": "cli", "argv": cli + ["--epochs", "1"]})
            cases.append({"kind": "cli", "name": "cli_resume",
                          "argv": cli + ["--epochs", "2", "--resume"]})
            sparse_cli = [a if a != ckpt else ckpt + "_sparse" for a in cli] + [
                "--table-optimizer", "adam"]
            cases.append({"kind": "cli", "name": "cli_sparse", "argv": sparse_cli + [
                "--epochs", "1"]})
            cases.append({"kind": "cli", "name": "cli_sparse_resume", "argv": sparse_cli + [
                "--epochs", "2", "--resume"]})
        path = os.path.join(root, f"out_{dp}x{mp}")
        logs[(dp, mp)] = worker.run_ranks(cases, path, world=dp * mp)
        out[(dp, mp)] = path
    return {"out": out, "logs": logs, "inputs": inputs, "root": root,
            "fit": (pt_serialize.to_json(fit_exp), splits), "cli": (data, ckpt)}


_ONE: dict = {}


def _one_process(spawned, name):
    """The port's step in this process (mp = 1) on the same inputs."""
    if name not in _ONE:
        from ctr_recommendation_tpu_torch.training import sparse

        exp, weights, batch, _, ratio = spawned["inputs"][name]
        before = sparse.GATHERED_MIN_VOCAB_RATIO
        if ratio is not None:
            sparse.GATHERED_MIN_VOCAB_RATIO = ratio
        try:
            _ONE[name] = worker.port_step(_port_json(exp, 1), weights, dict(np.load(batch)),
                                          ckpt=os.path.join(spawned["root"], f"one_{name}"))
        finally:
            sparse.GATHERED_MIN_VOCAB_RATIO = before
    return _ONE[name]


def _sharded(key: str) -> bool:
    """Whether a rank's output ``key`` holds its shard: the tables and the
    table optimizer's state."""
    return key.endswith(TABLES) or key.startswith("topt/")


def _assembled(spawned, layout, name) -> dict:
    """Data rank 0's results with each row-sharded leaf put together from
    its model ranks' shards; checks the replicas and shards agree."""
    dp, mp = layout
    ranks = [worker.load(spawned["out"][layout], name, r) for r in range(dp * mp)]
    for r, res in enumerate(ranks):
        assert list(res["coords"]) == [r // mp, r % mp, dp, mp]
        for k in res:
            if k.startswith(("param/", "state/", "topt/")) or k == "loss":
                same = ranks[r % mp] if _sharded(k) else ranks[0]
                np.testing.assert_array_equal(res[k], same[k], err_msg=f"rank {r}: {k}")
    got = dict(ranks[0])
    for k in got:
        if _sharded(k):
            got[k] = np.concatenate([ranks[m][k] for m in range(mp)])
    return got


def _bar(layout, name):
    """(rtol, atol share of the leaf's largest magnitude): 1e-6 where the
    ranks compute one process's sums; the data-parallel bar where a
    BatchNorm or the loss sums over data ranks."""
    return (1e-6, 1e-6) if layout[0] == 1 else (1e-4, 1e-5)


def _close(got, want, bar, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=bar[0],
                               atol=bar[1] * max(1.0, np.abs(want).max()), err_msg=msg)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_sharded_step_matches_one_process(spawned, layout, name):
    got = _assembled(spawned, layout, name)
    want = _one_process(spawned, name)
    assert sorted(k for k in got if k != "coords") == sorted(k for k in want if k != "coords")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    bar = _bar(layout, name)
    for k in want:
        # at 2 x 2 Adam's first step turns the noise gradients of the
        # BatchNorm-fed biases (true value 0, summed in another order) into
        # steps of lr: the parameters are held where the tables are
        if k.startswith(("grad/", "clip/", "topt/")) or (
                k.startswith("param/") and (layout[0] == 1 or k.endswith(TABLES))):
            _close(got[k], want[k], bar, k)
        elif k.startswith("state/"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", SPARSE)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_sparse_untouched_rows_bit_for_bit(spawned, layout, name):
    """The sparse table optimizers at mp 2: every row no id of the batch
    reads, of each table and of its optimizer state, bit for bit one
    process's (its init, left alone), on whichever rank owns it."""
    got = _assembled(spawned, layout, name)
    want = _one_process(spawned, name)
    b = dict(np.load(spawned["inputs"][name][2]))
    touched = {"item_id": np.union1d(b["item_id"], b["item_seq"]),
               "likes_level": np.union1d(b["likes_level"], b["views_level"])}
    for k in want:
        if not (_sharded(k) and k.startswith(("param/", "topt/"))):
            continue
        table = k.split("/")[-1] if k.startswith("param/") else k.split("/")[1]
        keep = np.ones(len(want[k]), bool)
        keep[touched[table]] = False
        assert keep.sum() > 0
        np.testing.assert_array_equal(got[k][keep], want[k][keep], err_msg=k)


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_clip_sums_the_shards(spawned, layout, name):
    """The clip was active and scaled every leaf by one factor: the global
    norm over the whole tables (one process's), so that each clipped leaf
    is clip / norm of its gradient, shards included."""
    got = _assembled(spawned, layout, name)
    grads = {k[len("grad/"):]: got[k] for k in got if k.startswith("grad/")}
    norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values())))
    assert norm > CLIP  # the clip is active
    for k, g in grads.items():
        _close(got["clip/" + k], g * (CLIP / norm), (1e-5, 1e-6), k)


_JAX: dict = {}


def _jax_step(spawned, layout):
    """JAX's ``_train_step`` on the (dp, mp) mesh with the all_to_all
    ``make_sharded_lookup`` (every table exchanged), from the a2a case's
    weights, and ``jax.grad`` of its loss clipped by optax's rule."""
    if layout in _JAX:
        return _JAX[layout]
    dp, mp = layout
    exp, _, batch, _, _ = spawned["inputs"]["a2a"]
    exp = exp.replace(mesh=JaxMeshConfig(data_parallel=dp, model_parallel=mp),
                      train=dataclasses.replace(exp.train, checkpoint_dir=os.path.join(
                          spawned["root"], f"jax_{dp}x{mp}")))
    mesh = jax_make_mesh(exp.mesh, devices=jax.devices()[: dp * mp])
    from ctr_recommendation_tpu.features import build_feature_map

    lookup = jax_lookup(mesh, feature_map=build_feature_map(exp.dataset), small_table_rows=0)
    jt = JaxTrainer(exp, mesh=mesh, total_steps=10, lookup=lookup, log_fn=lambda s: None)
    b = dict(np.load(batch))
    feats = {k: v for k, v in b.items() if k != "label"}

    def loss_fn(p):
        logits, _ = jt.module.apply(p, jt.state.model_state, jt.fm, exp.model, feats,
                                    train=True, rng=jax.random.key(0),
                                    compute_dtype=jnp.float32, lookup=lookup)
        return jax_bce(logits, jnp.asarray(b["label"]))

    grads = jax_bridge.flatten(np_tree(jax.jit(jax.grad(loss_fn))(jt.state.params)))
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    clipped = {k: g * (CLIP / norm) if norm >= CLIP else g for k, g in grads.items()}
    state, metrics = jt._train_step(jt.state, jt.put_batch(b), jax.random.key(0))
    _JAX[layout] = (float(metrics["loss"]), clipped,
                    np.asarray(state.params["trunk"]["tables"]["item_id"]))
    return _JAX[layout]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_sharded_step_matches_jax_on_the_same_mesh(spawned, layout):
    got = _assembled(spawned, layout, "a2a")
    loss, clipped, table = _jax_step(spawned, layout)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    keys = [k for k in got if k.startswith("clip/")]
    assert len(keys) == len(clipped)
    for k in keys:
        _close(got[k], clipped[k[len("clip/"):]], (1e-4, 1e-5), k)
    _close(got["param/trunk/tables/item_id"], table, (1e-6, 1e-6), "item table")


def test_fit_on_device_one_by_two_matches_one_process(spawned, tmp_path):
    """Both model ranks take one process's steps (the same rows and
    permutation; eval through the exchange), act on world rank 0's metrics,
    and only world rank 0 writes: its export and its last resume point hold
    whole tables and moments; rank 1's checkpoint directory stays empty."""
    experiment, splits = spawned["fit"]
    want = worker.port_fit(experiment, splits, str(tmp_path / "one"))
    out = spawned["out"][(1, 2)]
    got = worker.load(out, "fit")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert abs(g["train_loss"] - w["train_loss"]) < 1e-4, (g, w)
        assert abs(g["auc"] - w["auc"]) < 1e-3, (g, w)
        assert abs(g["logloss"] - w["logloss"]) < 1e-3, (g, w)
    metrics = ("epoch", "train_loss", "auc", "logloss")
    for g, g1 in zip(got, worker.load(out, "fit", 1)):
        assert [g[k] for k in metrics] == [g1[k] for k in metrics]
    root = spawned["root"]
    assert os.listdir(os.path.join(root, "ckpt_fit_1")) == []
    written = sorted(os.listdir(os.path.join(root, "ckpt_fit_0")))
    assert written == ["best", "ckpt_1.pt", "ckpt_2.pt", "experiment.json", "metrics.csv"]
    params, _ = jax_bridge.load(os.path.join(root, "ckpt_fit_0", "best", "export.npz"))
    assert params["trunk"]["tables"]["item_id"].shape == (256, 16)
    import torch

    point = torch.load(os.path.join(root, "ckpt_fit_0", "ckpt_2.pt"), weights_only=True)
    assert point["params"]["trunk"]["tables"]["item_id"].shape == (256, 16)
    assert {tuple(m.shape) for m in point["opt_state"]["mu"]} >= {(256, 16), (128, 16)}


def test_train_cli_model_parallel_checkpoint_serves_on_one_device(spawned, tmp_path, capsys):
    """The port's counterpart of tests/test_serving_mesh.py: the train CLI
    at --model-parallel 2 on two ranks (1 epoch, then --resume to 2), one
    checkpoint directory written by world rank 0, its experiment.json's
    mesh model_parallel 2; predict and evaluate in this process, one
    device, the serving mesh replicated."""
    from ctr_recommendation_tpu_torch.cli.evaluate import main as evaluate_main
    from ctr_recommendation_tpu_torch.cli.predict import main as predict_main
    from ctr_recommendation_tpu_torch.config import serialize

    out, logs = spawned["out"][(1, 2)], spawned["logs"][(1, 2)]
    for r in (0, 1):
        assert worker.load(out, "cli", r) == {"rc": 0}
        assert worker.load(out, "cli_resume", r) == {"rc": 0}
        assert "[resume] epoch 1" in logs[r], logs[r]
        # every epoch's rows: the model ranks share one data shard (dp = 1)
        assert logs[r].count("(900/") == 4, logs[r]  # 2 runs of 2 epochs (dense, sparse)
    data, ckpt = spawned["cli"]
    assert sorted(os.listdir(ckpt)) == [
        "best", "ckpt_1.pt", "ckpt_2.pt", "experiment.json", "metrics.csv"]
    assert serialize.load(os.path.join(ckpt, "experiment.json")).mesh.model_parallel == 2
    with open(os.path.join(ckpt, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(float(r["epoch"])) for r in rows] == [1, 2]
    best = max(float(r["auc"]) for r in rows)
    capsys.readouterr()
    pred = tmp_path / "pred"
    assert predict_main(["--data-root", data, "--checkpoint-dir", ckpt, "--out-dir", str(pred),
                         "--device", "cpu"]) == 0
    import pyarrow.parquet as pq

    n_test = pq.ParquetFile(os.path.join(data, "test.parquet")).metadata.num_rows
    lines = (pred / "prediction_fibinet.csv").read_text().splitlines()
    assert lines[0] == "ID,Task2" and len(lines) == 1 + n_test
    capsys.readouterr()
    assert evaluate_main(["--data-root", data, "--checkpoint-dir", ckpt, "--device", "cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[eval]")][0]
    # the Predictor's forward (BatchNorm folded, the fused scoring's plain
    # version) is not the trainer's eval forward: a pair or two of the 180
    # rows reorder, as in one process (tests/test_torch_dp_trainer.py)
    assert abs(float(line.split("AUC=")[1].split()[0]) - best) < 2e-3
    # the trainer's own eval forward on one device, from the export: the
    # exchange's rows were the whole tables' rows, so the AUC is the fit's
    from ctr_recommendation_tpu_torch.data import ItemStore, iter_batches, load_split
    from ctr_recommendation_tpu_torch.training import Trainer

    exp = serialize.load(os.path.join(ckpt, "experiment.json")).replace(mesh=MeshConfig())
    store = ItemStore.from_parquet(exp.dataset.item_info, id_col=exp.dataset.item_info_key,
                                   emb_col=exp.dataset.item_info_emb_col)
    tr = Trainer(exp, checkpoint_dir=ckpt, item_store=store, device="cpu", log_fn=lambda s: None)
    tr.load_best()
    valid = load_split(exp.dataset.valid_data, tr.fm)
    got = tr.evaluate(iter_batches(valid, tr.fm, exp.train.eval_batch_size))
    assert abs(got["auc"] - best) < 1e-6, (got, best)


def test_train_cli_model_parallel_sparse_tables_resume_and_serve(spawned, capsys):
    """--model-parallel 2 --table-optimizer adam (lazy Adam on the touched
    rows, each owner updating its own): the resume point holds the whole
    tables and the whole lazy-Adam moments, --resume slices them again and
    continues, and the export serves in one process."""
    import torch

    from ctr_recommendation_tpu_torch.cli.evaluate import main as evaluate_main

    out, logs = spawned["out"][(1, 2)], spawned["logs"][(1, 2)]
    for r in (0, 1):
        assert worker.load(out, "cli_sparse", r) == {"rc": 0}
        assert worker.load(out, "cli_sparse_resume", r) == {"rc": 0}
    assert logs[0].count("[resume] epoch 1") == 2  # the dense and the sparse run
    data, ckpt = spawned["cli"]
    ckpt += "_sparse"
    point = torch.load(os.path.join(ckpt, "ckpt_2.pt"), weights_only=True)
    assert point["params"]["trunk"]["tables"]["item_id"].shape == (256, 16)
    assert {k: tuple(v.shape) for k, v in point["table_opt_state"]["item_id"].items()} == {
        "mu": (256, 16), "nu": (256, 16)}
    assert int(point["step"]) == 18
    with open(os.path.join(ckpt, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    best = max(float(r["auc"]) for r in rows)
    capsys.readouterr()
    assert evaluate_main(["--data-root", data, "--checkpoint-dir", ckpt, "--device", "cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[eval]")][0]
    assert abs(float(line.split("AUC=")[1].split()[0]) - best) < 2e-3
