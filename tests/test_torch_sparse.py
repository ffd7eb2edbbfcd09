"""The port's sparse table optimizers against the JAX package's, on the CPU.

Seeded numpy inputs go through the JAX function and the port's:

* the id plumbing (``dedup_ids``, ``dedup_ids_inverse``, ``gather_rows``,
  ``remap_batch``), negative ids and batch * seq > vocab included: exactly
  equal;
* ``multi_feature_lookup`` and the trunk's ``gather``: the forward exactly
  equal, the (merged) backward within 1e-6 (summation order); ids out of
  range after the negative wrap read the clamped row and add no gradient,
  as in JAX;
* ``TableOptimizer.update`` and ``update_dense``, each kind, weight decay 0
  and 1e-5, five updates: rtol 1e-5; untouched rows and their state bit for
  bit unchanged; ``make_table_optimizer``'s family default;
* one sparse train step of the Trainer against the JAX ``Trainer._train_step``
  from bridged weights (fp32, dropout 0), each kind under each forced
  strategy, for mm_fibinet and sasrec_fibinet: loss, every parameter and
  every table state within rtol 1e-4 / atol 1e-5 of the leaf's largest
  magnitude (at least 1); the same for steps with ids past the tables'
  rows, dense and under each strategy;
* the slice as a whole: ``fit_on_device`` with rowwise_adagrad against the
  JAX one (per-epoch loss within 1e-3, AUC within 5e-3); resume equal to an
  uninterrupted sparse run; the train CLI with a sparse table optimizer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.data import ItemStore as JaxItemStore
from ctr_recommendation_tpu.data.parquet import TableData as JaxTableData
from ctr_recommendation_tpu.parallel.mesh import single_device_mesh
from ctr_recommendation_tpu.training import Trainer as JaxTrainer
from ctr_recommendation_tpu.training import sparse as jax_sparse
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.config.schema import TrainConfig
from ctr_recommendation_tpu_torch.data import ItemStore, TableData, synthetic_splits
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm
from ctr_recommendation_tpu_torch.models import trunk
from ctr_recommendation_tpu_torch.tools import jax_bridge
from ctr_recommendation_tpu_torch.training import Trainer
from ctr_recommendation_tpu_torch.training import sparse
from ctr_recommendation_tpu_torch.training.optim import make_optimizer
from tests.conftest import make_batch

torch.set_num_threads(2)

KINDS = ("adagrad", "rowwise_adagrad", "adam")
STRATEGIES = {"gathered": 0.0, "masked_dense": 1e12}  # GATHERED_MIN_VOCAB_RATIO forcing each


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _ids(rng, shape, vocab, negatives):
    ids = rng.integers(0, vocab, size=shape)
    if negatives:
        ids[rng.random(shape) < 0.1] = -1
    return ids.astype(np.int32)


# ------------------------------------------------------------- id plumbing
@pytest.mark.parametrize("shape, vocab, negatives", [
    ((37,), 64, False),         # fewer ids than rows: a sentinel tail
    ((16, 20), 64, False),      # batch * seq > vocab: capped at the vocab
    ((16, 20), 512, True),      # negatives sort first
    ((1,), 8, False),
    ((6,), 6, False),           # every row touched, no sentinel
])
def test_dedup_matches_jax(shape, vocab, negatives):
    ids = _ids(np.random.default_rng(len(shape) * vocab), shape, vocab, negatives)
    want_u, want_inv = jax_sparse.dedup_ids_inverse(jnp.asarray(ids), vocab)
    got_u, got_inv = sparse.dedup_ids_inverse(torch.from_numpy(ids), vocab)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_array_equal(got_inv.numpy(), np.asarray(want_inv))
    np.testing.assert_array_equal(sparse.dedup_ids(torch.from_numpy(ids), vocab).numpy(),
                                  np.asarray(jax_sparse.dedup_ids(jnp.asarray(ids), vocab)))
    table = np.random.default_rng(1).standard_normal((vocab, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        sparse.gather_rows(torch.from_numpy(table), got_u).numpy(),
        np.asarray(jax_sparse.gather_rows(jnp.asarray(table), want_u)))


@pytest.mark.parametrize("only", [None, ("item_id",)])
def test_remap_batch_matches_jax(tiny_experiment, tiny_feature_map, only):
    rng = np.random.default_rng(21)
    feats = make_batch(rng, 64)  # 64 * 8 + 64 + 1 item ids > the 256-row table
    feats["item_seq"][0, :3] = -1
    feats["item_id"][5] = -7
    rows = {t.name: ((t.vocab_size + 127) // 128) * 128 for t in tiny_feature_map.tables}
    want, want_u = jax_sparse.remap_batch(
        tiny_feature_map, {k: jnp.asarray(v) for k, v in feats.items()},
        {t: jnp.zeros((n, 2)) for t, n in rows.items()}, only=only)
    pt_fm = pt_build_fm(pt_serialize.from_json(jax_serialize.to_json(tiny_experiment)).dataset)
    got, got_u = sparse.remap_batch(
        pt_fm, {k: torch.from_numpy(v) for k, v in feats.items()},
        {t: torch.zeros(n, 2) for t, n in rows.items()}, only=only)
    assert sorted(got_u) == sorted(want_u) and sorted(got) == sorted(want)
    for t in want_u:
        np.testing.assert_array_equal(got_u[t].numpy(), np.asarray(want_u[t]))
        assert got_u[t][0] == 0  # the pad id forced in first
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert int(got["item_seq"][0, 0]) == 0  # a negative id reads as the pad


# -------------------------------------------------------------- the lookup
def test_multi_feature_lookup_matches_jax():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((40, 8)).astype(np.float32)
    ids = [_ids(rng, (24,), 40, True), _ids(rng, (6, 24), 40, True).T.copy()]
    # ids out of range after the negative wrap: the forward reads the clamped
    # row, the backward drops their cotangents (JAX's .at[ids].add)
    ids[0][[3, 7]] = [40, -50]
    ids[1][[5, 9], 2] = [41, 1 << 20]
    cots = [rng.standard_normal((*i.shape, 8)).astype(np.float32) for i in ids]

    def jax_loss(t):
        outs = jax_sparse.multi_feature_lookup(t, *[jnp.asarray(i) for i in ids])
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, want_outs), want_g = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    outs = sparse.multi_feature_lookup(t, *[torch.from_numpy(i) for i in ids])
    for o, w in zip(outs, want_outs):
        np.testing.assert_array_equal(o.detach().numpy(), np.asarray(w))
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    (g,) = torch.autograd.grad(loss, [t])
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=0, atol=1e-6)
    assert g[-1].abs().sum() > 0  # the -1 ids wrapped to the last row, both ways


@pytest.mark.parametrize("ids", [[1, 9, 5], [1, 9, 5, -1, -9, -6, 6]])
def test_gather_drops_out_of_range_gradients_as_jax(ids):
    """A (6, 2) table: an id at or past row 6 (after -6..-1 wrap) reads the
    clamped row and adds nothing to any row's gradient."""
    table = np.arange(12, dtype=np.float32).reshape(6, 2)
    want_out, vjp = jax.vjp(lambda t: t[jnp.asarray(ids)], jnp.asarray(table))
    (want_g,) = vjp(jnp.ones_like(want_out))
    t = torch.from_numpy(table).requires_grad_()
    out = trunk.gather(t, torch.tensor(ids, dtype=torch.int32))
    (g,) = torch.autograd.grad(out.sum(), [t])
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want_out))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want_g))
    assert g[5].tolist() == ([1.0, 1.0] if ids == [1, 9, 5] else [2.0, 2.0])


# ------------------------------------------------------- the table updates
def _schedule(count):
    return 0.05 * (1.0 + 0.1 * count)  # moves each step, so the count is checked


def _close_state(pt, pst, jt, jst):
    """Table and state within rtol 1e-5 and 1e-6 of the leaf's largest
    magnitude: the bias corrections are taken in float64 here, in float32
    by JAX."""
    pairs = [("table", pt["t"], jt["t"])] + [(k, pst["t"][k], jst["t"][k]) for k in pst["t"]]
    for k, got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("wd", [0.0, 1e-5])
@pytest.mark.parametrize("kind", KINDS)
def test_table_optimizer_update_matches_jax(kind, wd):
    V, E = 48, 8
    rng = np.random.default_rng(7)
    table = rng.standard_normal((V, E)).astype(np.float32)
    jopt = jax_sparse.TableOptimizer(kind=kind, schedule=lambda s: 0.05 * (1.0 + 0.1 * s),
                                     weight_decay=wd)
    popt = sparse.TableOptimizer(kind=kind, schedule=_schedule, weight_decay=wd)
    jt, jst = {"t": jnp.asarray(table)}, jopt.init({"t": jnp.asarray(table)})
    pt = {"t": torch.from_numpy(table.copy())}
    pst = popt.init(pt)
    for step in range(5):
        ids = np.concatenate([[0], rng.integers(1, V // 2, size=20)])  # rows >= V/2 untouched
        u = sparse.dedup_ids(torch.from_numpy(ids), V)
        rg = rng.standard_normal((u.numel(), E)).astype(np.float32)
        rg[u.numpy() >= V] = 0.0
        before = {k: v.clone() for k, v in pst["t"].items()}
        before["table"] = pt["t"].clone()
        jt, jst = jopt.update(jt, jst, {"t": jax_sparse.dedup_ids(jnp.asarray(ids), V)},
                              {"t": jnp.asarray(rg)}, jnp.asarray(step, jnp.int32))
        popt.update(pt, pst, {"t": u}, {"t": torch.from_numpy(rg)}, step)
        untouched = np.setdiff1d(np.arange(V), ids)
        for k, v in {**pst["t"], "table": pt["t"]}.items():
            assert torch.equal(v[untouched], before[k][untouched]), (k, step)
        _close_state(pt, pst, jt, jst)


@pytest.mark.parametrize("wd", [0.0, 1e-5])
@pytest.mark.parametrize("kind", KINDS)
def test_table_optimizer_update_dense_matches_jax(kind, wd):
    V, E = 48, 8
    rng = np.random.default_rng(8)
    table = rng.standard_normal((V, E)).astype(np.float32)
    jopt = jax_sparse.TableOptimizer(kind=kind, schedule=lambda s: 0.05 * (1.0 + 0.1 * s),
                                     weight_decay=wd)
    popt = sparse.TableOptimizer(kind=kind, schedule=_schedule, weight_decay=wd)
    jt, jst = {"t": jnp.asarray(table)}, jopt.init({"t": jnp.asarray(table)})
    pt = {"t": torch.from_numpy(table.copy())}
    pst = popt.init(pt)
    for step in range(5):
        g = rng.standard_normal((V, E)).astype(np.float32)
        untouched = np.flatnonzero(rng.random(V) < 0.4)
        g[untouched] = 0.0
        before = {k: v.clone() for k, v in pst["t"].items()}
        before["table"] = pt["t"].clone()
        jt, jst = jopt.update_dense(jt, jst, {"t": jnp.asarray(g)}, jnp.asarray(step, jnp.int32))
        popt.update_dense(pt, pst, {"t": torch.from_numpy(g)}, step)
        for k, v in {**pst["t"], "table": pt["t"]}.items():
            assert torch.equal(v[untouched], before[k][untouched]), (k, step)
        _close_state(pt, pst, jt, jst)


def test_make_table_optimizer_family_default():
    from ctr_recommendation_tpu.config.schema import TrainConfig as JaxTrainConfig

    base = lambda s: 1e-3 * (s + 1)  # noqa: E731
    for kind, scale, want in [("rowwise_adagrad", None, 10.0), ("adagrad", None, 10.0),
                              ("adam", None, 1.0), ("rowwise_adagrad", 3.0, 3.0)]:
        popt = sparse.make_table_optimizer(
            TrainConfig(table_optimizer=kind, table_lr_scale=scale, weight_decay=2e-5), base)
        jopt = jax_sparse.make_table_optimizer(
            JaxTrainConfig(table_optimizer=kind, table_lr_scale=scale, weight_decay=2e-5), base)
        assert (popt.kind, popt.weight_decay) == (jopt.kind, jopt.weight_decay) == (kind, 2e-5)
        for s in (0, 7):
            assert popt.schedule(s) == pytest.approx(want * base(s), rel=1e-12)
            assert popt.schedule(s) == pytest.approx(float(jopt.schedule(s)), rel=1e-6)
    assert sparse.make_table_optimizer(TrainConfig(), base) is None
    with pytest.raises(ValueError, match="unknown table_optimizer"):
        sparse.make_table_optimizer(TrainConfig(table_optimizer="sgd"), base)
    # the dense chain drops its clip: the sparse step clips jointly
    assert make_optimizer(TrainConfig(table_optimizer="adam"), 10, sparse_tables=True)[0] \
        .clip_norm == 0.0
    assert make_optimizer(TrainConfig(), 10)[0].clip_norm == 10.0


# -------------------------------------------------------- one train step
def _sparse_exp(tiny_experiment, table_opt, model="mm_fibinet", wd=1e-5, batch_norm=False,
                **train_kw):
    """fp32, no dropout, the dense chain on adagrad. BatchNorm off unless
    asked for: a Linear bias that feeds a train-mode BatchNorm has a true
    gradient of 0, and adagrad's g / sqrt(g^2 + 1e-10) turns the rounding
    noise there (another summation order on each side) into a step of up to
    lr / 10, which no parameter tolerance can hold."""
    model_cfg = dataclasses.replace(
        tiny_experiment.model, model=model, use_pallas=True, net_dropout=0.0,
        attn_dropout=0.0, tower_dtype="float32", batch_norm=batch_norm)
    tc = dataclasses.replace(
        tiny_experiment.train, optimizer="adagrad", table_optimizer=table_opt,
        weight_decay=wd, learning_rate=5e-3, table_lr_scale=1.0, compute_dtype="float32",
        async_checkpointing=False, tensorboard=False, **train_kw)
    return tiny_experiment.replace(model=model_cfg, train=tc)


def _labeled(rng, n=64, negatives=True):
    b = make_batch(rng, n)
    b["label"] = (rng.random(n) < 0.5).astype(np.float32)
    if negatives:  # the pad id for a gathered table, the last row for the others
        b["item_seq"][:3, :2] = -1
    return b


def _close(got, want, err_msg):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=err_msg)


def _port_trainer(exp, jt, tmp_path, **kw):
    pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
    pexp = pexp.replace(train=dataclasses.replace(pexp.train, checkpoint_dir=str(tmp_path)))
    pparams, pstate = jax_bridge.params_from_jax(
        np_tree(jt.state.params), np_tree(jt.state.model_state),
        pt_build_fm(pexp.dataset), pexp.model)
    return Trainer(pexp, params=pparams, model_state=pstate, device="cpu",
                   log_fn=lambda s: None, **kw)


@pytest.mark.parametrize("model", ["mm_fibinet", "sasrec_fibinet"])
@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("kind", KINDS)
def test_sparse_train_step_matches_jax(tiny_experiment, tmp_path, monkeypatch, kind, strategy,
                                       model):
    """Two steps from bridged weights, ids of -1 in the histories."""
    monkeypatch.setattr(jax_sparse, "GATHERED_MIN_VOCAB_RATIO", STRATEGIES[strategy])
    monkeypatch.setattr(sparse, "GATHERED_MIN_VOCAB_RATIO", STRATEGIES[strategy])
    exp = _sparse_exp(tiny_experiment, kind, model, checkpoint_dir=str(tmp_path / "jax"))
    jt = JaxTrainer(exp, mesh=single_device_mesh(), total_steps=10, log_fn=lambda s: None)
    pt = _port_trainer(exp, jt, tmp_path / "pt", total_steps=10)
    rng = np.random.default_rng(5)
    for _ in range(2):
        batch = _labeled(rng)
        jt.state, m = jt._train_step(jt.state, jt.put_batch(batch), jax.random.key(0))
        loss = pt.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(loss.item(), float(m["loss"]), rtol=1e-5)
    want = jax_bridge.flatten(np_tree(jt.state.params))
    for path, got in jax_bridge.flatten(pt.state.params).items():
        _close(got.detach(), want[path], path)
    want_t = np_tree(jt.state.table_opt_state)
    assert sorted(pt.state.table_opt_state) == sorted(want_t)
    for t, st in pt.state.table_opt_state.items():
        assert sorted(st) == sorted(want_t[t])
        for k, v in st.items():
            _close(v, want_t[t][k], f"{t}/{k}")
    assert pt.state.step == int(jt.state.step) == 2


@pytest.mark.parametrize("table_opt, strategy", [
    ("dense", None), ("adam", "gathered"), ("adam", "masked_dense")])
def test_train_step_with_out_of_range_ids_matches_jax(tiny_experiment, tmp_path, monkeypatch,
                                                      table_opt, strategy):
    """Two steps whose item_id and item_seq hold ids past the item table's
    256 rows: they read the last row and move no row, in both packages
    (under the sparse strategies: a sentinel slot whose update is dropped)."""
    if strategy is not None:
        monkeypatch.setattr(jax_sparse, "GATHERED_MIN_VOCAB_RATIO", STRATEGIES[strategy])
        monkeypatch.setattr(sparse, "GATHERED_MIN_VOCAB_RATIO", STRATEGIES[strategy])
    exp = _sparse_exp(tiny_experiment, table_opt, checkpoint_dir=str(tmp_path / "jax"))
    jt = JaxTrainer(exp, mesh=single_device_mesh(), total_steps=10, log_fn=lambda s: None)
    pt = _port_trainer(exp, jt, tmp_path / "pt", total_steps=10)
    rng = np.random.default_rng(6)
    for _ in range(2):
        batch = _labeled(rng)
        batch["item_id"][[0, 5]] = [300, 1 << 20]
        batch["item_seq"][[2, 7], [3, 1]] = [256, 5000]
        jt.state, m = jt._train_step(jt.state, jt.put_batch(batch), jax.random.key(0))
        loss = pt.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(loss.item(), float(m["loss"]), rtol=1e-5)
    want = jax_bridge.flatten(np_tree(jt.state.params))
    for path, got in jax_bridge.flatten(pt.state.params).items():
        _close(got.detach(), want[path], path)


# ------------------------------------------------------------- the trainer
def test_sparse_adagrad_matches_the_dense_chain_and_fusing_changes_nothing(tiny_experiment,
                                                                         tmp_path, monkeypatch):
    """Port only: at weight_decay 0 the adagrad tables, under either
    strategy, follow the dense adagrad chain (2e-5); the merged-backward
    lookup follows the per-feature gathers, dense and sparse. No negative
    ids: the gathered strategy reads them as the pad, the others wrap."""
    rng = np.random.default_rng(13)
    batches = [{k: torch.from_numpy(v) for k, v in _labeled(rng, negatives=False).items()}
               for _ in range(3)]

    def run(table_opt, fuse=True, ratio=4.0):
        monkeypatch.setattr(sparse, "GATHERED_MIN_VOCAB_RATIO", ratio)
        exp = pt_serialize.from_json(jax_serialize.to_json(
            _sparse_exp(tiny_experiment, table_opt, wd=0.0, checkpoint_dir=str(tmp_path))))
        tr = Trainer(exp, total_steps=10, device="cpu", log_fn=lambda s: None)
        tr._fuse_table_gather = fuse
        losses = [tr.train_step(b).item() for b in batches]
        return losses, {p: v.detach().clone() for p, v in tr.param_paths.items()}

    dense = run("dense")
    for other in (run("adagrad", ratio=0.0), run("adagrad", ratio=1e12)):
        for p, v in dense[1].items():
            torch.testing.assert_close(other[1][p], v, rtol=0, atol=2e-5, msg=p)
    for table_opt in ("dense", "rowwise_adagrad"):
        fused, split = run(table_opt), run(table_opt, fuse=False)
        np.testing.assert_allclose(fused[0], split[0], rtol=1e-6)
        for p, v in fused[1].items():
            torch.testing.assert_close(split[1][p], v, rtol=1e-5, atol=1e-6, msg=p)


def test_the_merged_lookup_serves_the_item_table(tiny_experiment, tmp_path):
    """Both models plan the item table (item_id + item_seq) in the layout the
    trunk asks for, and a square history (S == B) keeps per-feature gathers."""
    for model, transposed in (("mm_fibinet", True), ("sasrec_fibinet", False)):
        exp = pt_serialize.from_json(jax_serialize.to_json(
            _sparse_exp(tiny_experiment, "dense", model, checkpoint_dir=str(tmp_path))))
        tr = Trainer(exp, total_steps=10, device="cpu", log_fn=lambda s: None)
        feats = {k: torch.from_numpy(v) for k, v in make_batch(np.random.default_rng(0), 16)
                 .items()}
        plan = tr._multi_feature_plan(feats)
        assert list(plan) == ["item_id", "likes_level"]  # likes_level + views_level too
        (n1, ids1), (n2, ids2) = plan["item_id"]
        assert (n1, n2) == ("item_id", "item_seq")
        assert torch.equal(ids2, feats["item_seq"].t() if transposed else feats["item_seq"])
        square = {k: v[:8] for k, v in feats.items()}  # 8 rows of 8-item histories
        assert list(tr._multi_feature_plan(square)) == ["likes_level"]


def test_sparse_trainer_refuses_a_nonzero_pad_id(tiny_experiment, tmp_path):
    exp = pt_serialize.from_json(jax_serialize.to_json(
        _sparse_exp(tiny_experiment, "adam", checkpoint_dir=str(tmp_path))))
    feats = [dataclasses.replace(f, pad_id=3) if f.name == "item_seq" else f
             for f in exp.dataset.features]
    exp = exp.replace(dataset=dataclasses.replace(exp.dataset, features=feats))
    with pytest.raises(ValueError, match="requires pad_id 0"):
        Trainer(exp, total_steps=10, device="cpu", log_fn=lambda s: None)


# ------------------------------------------------------- the slice as whole
def _splits(n_train, n_valid, seed=0):
    train, valid, store = synthetic_splits(
        n_train, n_valid, num_items=199, max_len=8, mm_dim=24, num_users=100, seed=seed)
    ids = np.flatnonzero(store.known_mask)
    return train.columns, valid.columns, ids, store.emb[ids]


def test_fit_on_device_rowwise_adagrad_matches_jax(tiny_experiment, tmp_path):
    train, valid, ids, emb = _splits(1024, 512)
    exp = _sparse_exp(tiny_experiment, "rowwise_adagrad", checkpoint_dir=str(tmp_path / "jax"),
                      shuffle=False, epochs=2, eval_batch_size=256, log_every=10_000)
    exp = exp.replace(
        model=dataclasses.replace(exp.model, batch_norm=True),
        train=dataclasses.replace(exp.train, optimizer="adam", learning_rate=1e-3,
                                  table_lr_scale=None))  # the 10x default
    spe = 1024 // exp.train.batch_size
    jt = JaxTrainer(exp, mesh=single_device_mesh(), steps_per_epoch=spe,
                    item_store=JaxItemStore.from_arrays(ids, emb), log_fn=lambda s: None)
    pt = _port_trainer(exp, jt, tmp_path / "pt", steps_per_epoch=spe,
                       item_store=ItemStore.from_arrays(ids, emb))
    want = jt.fit_on_device(JaxTableData(train, 1024), JaxTableData(valid, 512))
    got = pt.fit_on_device(TableData(train, 1024), TableData(valid, 512))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert abs(g["train_loss"] - w["train_loss"]) < 1e-3, (g, w)
        assert abs(g["auc"] - w["auc"]) < 5e-3, (g, w)
    assert got[-1]["train_loss"] < got[0]["train_loss"]
    assert max(h["auc"] for h in got) > 0.6
    assert pt.state.step == int(jt.state.step) == 2 * spe


def test_sparse_resume_equals_an_uninterrupted_run(tiny_experiment, tmp_path):
    train, valid, ids, emb = _splits(512, 256, seed=1)
    store = ItemStore.from_arrays(ids, emb)

    def trainer(epochs, ckpt):
        e = pt_serialize.from_json(jax_serialize.to_json(_sparse_exp(
            tiny_experiment, "adam", checkpoint_dir=str(ckpt), epochs=epochs, shuffle=True,
            eval_batch_size=256)))
        e = e.replace(model=dataclasses.replace(e.model, net_dropout=0.2))
        return Trainer(e, total_steps=3 * 8, item_store=store, device="cpu",
                       log_fn=lambda s: None)

    whole = trainer(3, tmp_path / "whole")
    whole.fit_on_device(TableData(train, 512), TableData(valid, 256))
    trainer(2, tmp_path / "cut").fit_on_device(TableData(train, 512), TableData(valid, 256))
    resumed = trainer(3, tmp_path / "cut")
    hist = resumed.fit_on_device(TableData(train, 512), TableData(valid, 256), resume=True)
    assert len(hist) == 1 and resumed.state.step == 3 * 8
    for a, b in zip(resumed.param_leaves, whole.param_leaves):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for t, st in whole.state.table_opt_state.items():
        for k, v in st.items():
            torch.testing.assert_close(resumed.state.table_opt_state[t][k], v, rtol=0, atol=0)
    assert hist[0]["auc"] == whole.history[-1]["auc"]


def test_train_cli_runs_a_sparse_table_optimizer(tmp_path, capsys):
    from ctr_recommendation_tpu_torch.cli.predict import main as predict_main
    from ctr_recommendation_tpu_torch.cli.train import main as train_main

    data, ckpt = tmp_path / "data", tmp_path / "ckpt"
    rc = train_main([
        "--synthetic", str(data), "--synthetic-rows", "3000", "--synthetic-items", "300",
        "--epochs", "1", "--embedding-dim", "16", "--batch-size", "256",
        "--table-optimizer", "adam", "--table-lr-scale", "2",
        "--checkpoint-dir", str(ckpt), "--device", "cpu",
    ])
    assert rc == 0
    saved = pt_serialize.load(str(ckpt / "experiment.json"))
    assert (saved.train.table_optimizer, saved.train.table_lr_scale) == ("adam", 2.0)
    state = torch.load(ckpt / "ckpt_1.pt", weights_only=True)["table_opt_state"]
    assert sorted(state["item_id"]) == ["mu", "nu"]
    assert "[epoch 1]" in capsys.readouterr().out
    assert predict_main(["--data-root", str(data), "--checkpoint-dir", str(ckpt),
                         "--out-dir", str(tmp_path / "out"), "--device", "cpu"]) == 0
