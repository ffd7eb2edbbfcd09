"""The port's host-driven trainer (``Trainer.fit``) against the JAX
package's, on the CPU.

Seeded numpy inputs (the tiny experiment's schema) go through the JAX
function and its counterpart in the port:

* ``_chunked`` groups and flushes as JAX's does; ``_wire_dtype`` picks
  JAX's plan for every column (uint8, uint16, split24, none) at three item
  vocabularies and with soft labels first;
* ``put_chunk`` then ``_widen`` gives back ``put_batch``'s tensors exactly,
  dtype and value, and a column outgrowing its plan mid-stream widens (the
  "widening" log) with its values intact;
* ``Trainer.fit`` at one batch an upload against the JAX ``Trainer.fit`` from
  bridged weights (fp32, ``net_dropout=0``, the interaction kernel's plain
  version against JAX's in Pallas interpret mode, the same shuffled
  ``iter_batches``): per-epoch train loss within 1e-3, AUC within 5e-3,
  logloss within 1e-3 (``test_fit_on_device_matches_jax``'s bars: the same
  arithmetic, summed in another order over 2 epochs), the same step count,
  dense tables and rowwise_adagrad;
* ``fit`` at 4 batches an upload (a tail chunk of 3) EQUALS ``fit`` at 1:
  ``torch.equal`` on every parameter and every history value but the
  timings, dense and sparse;
* the host item join (``strict_items``): the first step's loss equal to the
  device join's, an unknown item raising through ``fit``;
* soft labels mid-stream, resume, ``evaluate`` (exact and binned) against
  JAX's, ``predict`` dropping pad rows;
* the train CLI's ``--stream``, ``--strict-items`` and
  ``--steps-per-dispatch``, and predict ``--stream`` writing the default
  path's bytes.
"""

import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.config.loader import microlens_features as jax_microlens_features
from ctr_recommendation_tpu.data import ItemStore as JaxItemStore
from ctr_recommendation_tpu.data import iter_batches as jax_iter_batches
from ctr_recommendation_tpu.data.parquet import TableData as JaxTableData
from ctr_recommendation_tpu.parallel.mesh import single_device_mesh
from ctr_recommendation_tpu.training import Trainer as JaxTrainer
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.data import ItemStore, TableData, iter_batches, synthetic_splits
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm
from ctr_recommendation_tpu_torch.tools import jax_bridge
from ctr_recommendation_tpu_torch.training import Trainer

torch.set_num_threads(2)

TIMINGS = ("examples_per_sec", "seconds", "eval_seconds", "checkpoint_seconds")


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _splits(n_train, n_valid, seed=0):
    """Tiny high-signal splits in the tiny experiment's schema: (train cols,
    valid cols, item ids, item vectors)."""
    train, valid, store = synthetic_splits(
        n_train, n_valid, num_items=199, max_len=8, mm_dim=24, num_users=100, seed=seed)
    ids = np.flatnonzero(store.known_mask)
    return train.columns, valid.columns, ids, store.emb[ids]


def _exp(tiny_experiment, tmp, k=1, **train_kw):
    cfg = dataclasses.replace(
        tiny_experiment.model, use_pallas=True, net_dropout=0.0, tower_dtype="float32")
    train = dataclasses.replace(tiny_experiment.train, **{
        "compute_dtype": "float32", "epochs": 2, "checkpoint_dir": str(tmp),
        "eval_batch_size": 96, "log_every": 10_000, "async_checkpointing": False,
        "tensorboard": False, "steps_per_dispatch": k, **train_kw})
    return tiny_experiment.replace(model=cfg, train=train)


def _port(exp, tmp, **kw):
    pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
    pexp = pexp.replace(train=dataclasses.replace(pexp.train, checkpoint_dir=str(tmp)))
    return Trainer(pexp, device="cpu", log_fn=kw.pop("log_fn", lambda s: None), **kw)


def _batches(cols, n, fm, exp, **kw):
    """fit's train_batches: this epoch's shuffled full batches."""
    return lambda epoch: iter_batches(TableData(cols, n), fm, exp.train.batch_size,
                                      shuffle=True, seed=exp.train.seed, epoch=epoch,
                                      drop_last=True, **kw)


# ------------------------------------------------------- chunks and the wire
def test_chunked_groups_and_flushes_as_jax():
    rng = np.random.default_rng(0)
    shapes = [(4,), (4,), (4,), (4,), (2,), (4,), (4,), (4,), (4,), (4,), (4,)]
    batches = [{"a": rng.standard_normal(s).astype(np.float32)} for s in shapes]
    batches[7]["a"] = batches[7]["a"].astype(np.float64)  # a dtype change flushes too
    for k in (1, 3, 4, 20):
        got = list(Trainer._chunked(iter(batches), k))
        want = list(JaxTrainer._chunked(iter(batches), k))
        assert [[id(b) for b in c] for c in got] == [[id(b) for b in c] for c in want]
    assert [len(c) for c in Trainer._chunked(iter(batches), 3)] == [3, 1, 1, 2, 1, 3]


def _vocab_exp(tiny_experiment, item_vocab, tmp):
    ds = dataclasses.replace(tiny_experiment.dataset, features=jax_microlens_features(
        item_vocab=item_vocab, cate_vocab=11, max_len=8, mm_dim=24))
    return _exp(tiny_experiment.replace(dataset=ds), tmp)


def _wire_batch(rng, item_hi, n=8, soft=False):
    return {
        "user_id": rng.integers(0, 50, size=n).astype(np.int32),
        "likes_level": rng.integers(0, 11, size=n).astype(np.int32),
        "views_level": rng.integers(0, 11, size=n).astype(np.int32),
        "item_id": rng.integers(1, item_hi, size=n).astype(np.int32),
        "item_seq": rng.integers(0, item_hi, size=(n, 8)).astype(np.int32),
        "label": (rng.random(n) if soft else (rng.random(n) < 0.5)).astype(np.float32),
        "__weight__": np.ones(n, np.float32),
    }


@pytest.mark.parametrize("item_vocab, soft", [
    (200, False), (30_000, False), (70_000, False), (70_000, True)])
def test_wire_dtype_picks_jaxs_plan(tiny_experiment, tmp_path, item_vocab, soft):
    exp = _vocab_exp(tiny_experiment, item_vocab, tmp_path / "jax")
    jt = JaxTrainer(exp, mesh=single_device_mesh(), total_steps=4, log_fn=lambda s: None)
    pt = _port(exp, tmp_path / "pt", total_steps=4)
    b = _wire_batch(np.random.default_rng(1), min(item_vocab, 70_000), soft=soft)
    plan = {}
    for k, v in b.items():
        stacked = np.stack([v, v])
        plan[k] = pt._wire_dtype(k, stacked)
        assert plan[k] == jt._wire_dtype(k, stacked), k
    want_ids = {200: np.uint8, 30_000: np.uint16, 70_000: "split24"}[item_vocab]
    assert plan["item_id"] == plan["item_seq"] == want_ids
    assert plan["likes_level"] == np.uint8 and plan["user_id"] is None
    assert plan["label"] == (None if soft else np.uint8) and plan["__weight__"] == np.uint8


@pytest.mark.parametrize("item_vocab", [200, 30_000, 70_000])
def test_put_chunk_widens_back_to_put_batch(tiny_experiment, tmp_path, item_vocab):
    """Each slice of a widened chunk is put_batch's batch, dtype and value
    (the PLACEHOLDER user_id stays off the wire); a later chunk whose ids
    outgrow 24 bits, or whose labels turn soft, widens that column and logs
    it, its values intact, while the rest keep their plan."""
    exp = _vocab_exp(tiny_experiment, item_vocab, tmp_path)
    logs = []
    pt = _port(exp, tmp_path / "pt", total_steps=4, log_fn=logs.append)
    rng = np.random.default_rng(2)
    hi = min(item_vocab, 70_000)

    def check(buf):
        wide = pt._widen(pt._ready(pt.put_chunk(buf)))
        assert sorted(wide) == sorted(k for k in buf[0] if k != "user_id")
        for i, b in enumerate(buf):
            want = pt._ready(pt.put_batch(b))
            for k, v in wide.items():
                assert v[i].dtype == want[k].dtype and torch.equal(v[i], want[k]), k
        return wide

    check([_wire_batch(rng, hi) for _ in range(3)])
    assert not logs
    bad = [_wire_batch(rng, hi) for _ in range(2)]
    bad[1]["item_seq"][0, 0] = (1 << 24) + 5
    bad[0]["label"] = rng.random(8).astype(np.float32)
    check(bad)
    assert any("'label'" in m and "widening" in m for m in logs)
    assert any("'item_seq'" in m and "widening" in m for m in logs)
    assert "item_seq" not in pt._wire_plan and "label" not in pt._wire_plan
    assert "item_id" in pt._wire_plan
    check([_wire_batch(rng, hi) for _ in range(2)])  # the plan stays widened


# ---------------------------------------------------------------- the fit
@pytest.mark.parametrize("table_opt", ["dense", "rowwise_adagrad"])
def test_fit_matches_jax(tiny_experiment, tmp_path, table_opt):
    train, valid, ids, emb = _splits(1024, 400)
    exp = _exp(tiny_experiment, tmp_path / "jax", table_optimizer=table_opt)
    spe = 1024 // exp.train.batch_size
    jt = JaxTrainer(exp, mesh=single_device_mesh(), steps_per_epoch=spe,
                    item_store=JaxItemStore.from_arrays(ids, emb), log_fn=lambda s: None)
    pparams, pstate = jax_bridge.params_from_jax(
        np_tree(jt.state.params), np_tree(jt.state.model_state),
        pt_build_fm(pt_serialize.from_json(jax_serialize.to_json(exp)).dataset), exp.model)
    pt = _port(exp, tmp_path / "pt", steps_per_epoch=spe, params=pparams, model_state=pstate,
               item_store=ItemStore.from_arrays(ids, emb))
    want = jt.fit(
        lambda epoch: jax_iter_batches(JaxTableData(train, 1024), jt.fm, 64, shuffle=True,
                                       seed=exp.train.seed, epoch=epoch, drop_last=True),
        lambda: jax_iter_batches(JaxTableData(valid, 400), jt.fm, 96))
    got = pt.fit(_batches(train, 1024, pt.fm, exp),
                 lambda: iter_batches(TableData(valid, 400), pt.fm, 96))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert abs(g["train_loss"] - w["train_loss"]) < 1e-3, (g, w)
        assert abs(g["auc"] - w["auc"]) < 5e-3, (g, w)
        assert abs(g["logloss"] - w["logloss"]) < 1e-3, (g, w)
    assert sorted(got[0]) == ["auc", "checkpoint_seconds", "epoch", "eval_seconds",
                              "examples_per_sec", "logloss", "seconds", "train_loss"]
    assert got[-1]["train_loss"] < got[0]["train_loss"] and max(h["auc"] for h in got) > 0.6
    assert pt.state.step == int(jt.state.step) == 2 * spe
    assert pt.ckpt.latest_step() == 2 and (tmp_path / "pt" / "best" / "export.npz").exists()


def _fit_k(tiny_experiment, tmp, k, table_opt="dense", epochs=2, resume=False, spe=11):
    train, valid, ids, emb = _splits(11 * 64 + 20, 300, seed=4)
    exp = _exp(tiny_experiment, tmp, k=k, table_optimizer=table_opt, epochs=epochs)
    exp = exp.replace(model=dataclasses.replace(exp.model, net_dropout=0.2))  # masks replay
    pt = _port(exp, tmp, total_steps=3 * spe, item_store=ItemStore.from_arrays(ids, emb))
    hist = pt.fit(_batches(train, 11 * 64 + 20, pt.fm, exp),
                  lambda: iter_batches(TableData(valid, 300), pt.fm, 96), resume=resume)
    return pt, hist


@pytest.mark.parametrize("table_opt", ["dense", "adam"])
def test_fit_in_chunks_of_4_equals_one_batch_an_upload(tiny_experiment, tmp_path, table_opt):
    """11 steps an epoch: chunks of 4, 4 and 3 against 11 single uploads,
    dropout on."""
    one, h1 = _fit_k(tiny_experiment, tmp_path / "k1", 1, table_opt)
    four, h4 = _fit_k(tiny_experiment, tmp_path / "k4", 4, table_opt)
    assert one.state.step == four.state.step == 22
    for a, b in zip(one.param_leaves, four.param_leaves):
        assert torch.equal(a, b)
    for a, b in zip(h1, h4):
        assert sorted(a) == sorted(b)
        assert {k: v for k, v in a.items() if k not in TIMINGS} == \
            {k: v for k, v in b.items() if k not in TIMINGS}


def test_fit_resume_equals_an_uninterrupted_run(tiny_experiment, tmp_path):
    whole, _ = _fit_k(tiny_experiment, tmp_path / "whole", 4, epochs=3)
    _fit_k(tiny_experiment, tmp_path / "cut", 4, epochs=2)
    resumed, hist = _fit_k(tiny_experiment, tmp_path / "cut", 4, epochs=3, resume=True)
    assert len(hist) == 1 and resumed.state.step == whole.state.step == 33
    for a, b in zip(resumed.param_leaves, whole.param_leaves):
        assert torch.equal(a, b)
    assert hist[0]["auc"] == whole.history[-1]["auc"]
    with open(tmp_path / "cut" / "metrics.csv") as f:
        assert len(f.read().strip().splitlines()) == 1 + 3  # header + every epoch


def test_host_join_first_loss_equals_the_device_joins(tiny_experiment, tmp_path):
    """strict_items: no item store on the trainer, the batches carry the
    joined float32 rows; the first step's loss is the device join's bit for
    bit; an unknown item_id raises through fit."""
    train, _, ids, emb = _splits(512, 64, seed=5)
    exp = _exp(tiny_experiment, tmp_path, k=2)
    host = ItemStore.from_arrays(ids, emb)
    device_join = _port(exp, tmp_path / "dev", total_steps=8, item_store=host)
    host_join = _port(exp, tmp_path / "host", total_steps=8)
    assert not host_join._mm_tables
    batch = next(iter_batches(TableData(train, 512), host_join.fm, 64, shuffle=True, seed=1,
                              drop_last=True, item_store=host, strict_items=True))
    assert batch["item_emb_d128"].dtype == np.float32
    loss_dev = device_join.train_step({k: torch.from_numpy(v) for k, v in batch.items()
                                       if k != "item_emb_d128"})
    loss_host = host_join.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert torch.equal(loss_dev, loss_host)
    hist = host_join.fit(lambda epoch: itertools.islice(
        iter_batches(TableData(train, 512), host_join.fm, 64, shuffle=True, seed=1, epoch=epoch,
                     drop_last=True, item_store=host, strict_items=True), 5))
    assert len(hist) == 2 and host_join.state.step == 1 + 10
    bad = {k: v.copy() for k, v in train.items()}
    bad["item_id"][200] = 400  # not in item_info
    with pytest.raises(KeyError, match=r"item_ids not in item_info: \[400\]"):
        host_join.fit(lambda epoch: iter_batches(
            TableData(bad, 512), host_join.fm, 64, drop_last=True, item_store=host,
            strict_items=True))


def test_soft_labels_mid_stream_complete_training(tiny_experiment, tmp_path):
    """Labels turn soft halfway through the epoch: the label column widens
    on the wire ("widening" logged) and the run trains through, every step."""
    train, _, ids, emb = _splits(11 * 64, 64, seed=6)
    exp = _exp(tiny_experiment, tmp_path, k=3, epochs=1)
    logs = []
    pt = _port(exp, tmp_path / "pt", total_steps=11, item_store=ItemStore.from_arrays(ids, emb),
               log_fn=logs.append)

    def train_batches(epoch):
        rng = np.random.default_rng(5)
        for i, b in enumerate(_batches(train, 11 * 64, pt.fm, exp)(epoch)):
            if i >= 11 // 2:
                b["label"] = rng.uniform(0.1, 0.9, size=64).astype(np.float32)
            yield b

    hist = pt.fit(train_batches)
    assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
    assert pt.state.step == 11
    assert any("widening" in m for m in logs)


# -------------------------------------------------------------------- eval
@pytest.mark.parametrize("bins", [0, 4096])
def test_evaluate_matches_jax(tiny_experiment, tmp_path, bins):
    """The same weights, the valid split in eval batches of 96 (the last
    padded at weight 0)."""
    _, valid, ids, emb = _splits(64, 500, seed=7)
    exp = _exp(tiny_experiment, tmp_path / "jax", num_eval_threshold_bins=bins)
    jt = JaxTrainer(exp, mesh=single_device_mesh(), total_steps=4,
                    item_store=JaxItemStore.from_arrays(ids, emb), log_fn=lambda s: None)
    pparams, pstate = jax_bridge.params_from_jax(
        np_tree(jt.state.params), np_tree(jt.state.model_state),
        pt_build_fm(pt_serialize.from_json(jax_serialize.to_json(exp)).dataset), exp.model)
    pt = _port(exp, tmp_path / "pt", total_steps=4, params=pparams, model_state=pstate,
               item_store=ItemStore.from_arrays(ids, emb))
    want = jt.evaluate(jax_iter_batches(JaxTableData(valid, 500), jt.fm, 96))
    got = pt.evaluate(iter_batches(TableData(valid, 500), pt.fm, 96))
    assert abs(got["auc"] - want["auc"]) < 1e-5 and abs(got["logloss"] - want["logloss"]) < 1e-5
    if not bins:  # the padded batches score as the resident split does
        table = pt.evaluate_table(TableData(valid, 500), batch_size=96)
        assert got == table


def test_predict_drops_pad_rows(tiny_experiment, tmp_path):
    _, valid, ids, emb = _splits(64, 500, seed=8)
    pt = _port(_exp(tiny_experiment, tmp_path), tmp_path / "pt", total_steps=4,
               item_store=ItemStore.from_arrays(ids, emb))
    probs = pt.predict(iter_batches(TableData(valid, 500), pt.fm, 96))
    assert probs.shape == (500,) and probs.dtype == np.float32
    want = pt._predict_prepared(pt._prepare_eval_split(TableData(valid, 500), 96))[:500]
    np.testing.assert_array_equal(probs, want.numpy())


# -------------------------------------------------------------------- CLIs
@pytest.mark.parametrize("flags", [
    ["--stream"],
    ["--strict-items"],
    ["--stream", "--strict-items", "--steps-per-dispatch", "3"],
])
def test_train_cli_host_driven_paths_train_and_export(tmp_path, flags, capsys):
    from ctr_recommendation_tpu_torch.cli.train import main as train_main

    data, ckpt = tmp_path / "data", tmp_path / "ckpt"
    rc = train_main([
        "--synthetic", str(data), "--synthetic-rows", "3000", "--synthetic-items", "300",
        "--epochs", "2", "--embedding-dim", "16", "--batch-size", "256",
        "--checkpoint-dir", str(ckpt), "--device", "cpu", *flags,
    ])
    assert rc == 0
    assert (ckpt / "best" / "export.npz").exists() and (ckpt / "ckpt_2.pt").exists()
    out = capsys.readouterr().out
    assert "[epoch 2] loss" in out and "(2048/" in out  # 8 steps of 256 an epoch


def test_predict_cli_stream_writes_the_default_paths_rows(tmp_path):
    from ctr_recommendation_tpu_torch.cli.predict import main as predict_main
    from ctr_recommendation_tpu_torch.cli.train import main as train_main

    data, ckpt = tmp_path / "data", tmp_path / "ckpt"
    assert train_main([
        "--synthetic", str(data), "--synthetic-rows", "3000", "--synthetic-items", "300",
        "--epochs", "1", "--embedding-dim", "16", "--batch-size", "256",
        "--checkpoint-dir", str(ckpt), "--device", "cpu", "--stream",
    ]) == 0
    outs = {}
    for tag, extra in (("pipeline", []), ("stream", ["--stream"])):
        assert predict_main([
            "--data-root", str(data), "--checkpoint-dir", str(ckpt),
            "--out-dir", str(tmp_path / tag), "--batch-size", "128", "--device", "cpu", *extra,
        ]) == 0
        outs[tag] = (tmp_path / tag / "prediction_fibinet.csv").read_bytes()
    assert outs["stream"] == outs["pipeline"]
    assert outs["stream"].decode().splitlines()[0] == "ID,Task2"
    assert len(outs["stream"].decode().splitlines()) == 1 + 300
