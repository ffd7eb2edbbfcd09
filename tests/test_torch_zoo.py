"""The port's model zoo against the JAX package's, on the CPU.

The nine zoo models (din, xdeepfm, finalmlp, dcnv2, deepfm, autoint,
masknet, pnn, dlrm) at tiny widths: the JAX ``init``'s weights go through
tools/jax_bridge.params_from_jax into the port, seeded numpy batches through
both packages.

* one fp32 train-mode step per model (dropout 0, a padded tail of
  zero-weight rows): the loss to rtol 1e-5; the logits and every parameter
  gradient to rtol 1e-4 / atol 1e-5 of the leaf's largest magnitude (at
  least 1), summation order only, as tests/test_torch_training.py holds
  fibinet; the BatchNorm running statistics to rtol 1e-5 / atol 1e-6.
  xDeepFM's CIN head starts at zero, which makes every filter gradient 0
  on both sides: its case first sets the head to seeded non-zero values;
* the bf16 eval logits (BatchNorm statistics moved off init) within
  BF16_LOGIT_TOL; AutoInt's interacting layers, which JAX's type promotion
  runs in fp32 under a bf16 trunk, give fp32 outputs equal to JAX's within
  the fp32 bar;
* the ops: ``din_pool`` (an all-pad history pools to zeros), the CIN at two
  and three layers, the CrossNet, in fp32 and bf16;
* ``fit_on_device`` against the JAX Trainer for din, xdeepfm and finalmlp
  (per-epoch loss within 1e-3, AUC within 5e-3, as for fibinet), and one
  sparse-table step (rowwise_adagrad, each strategy) for din, whose
  history is looked up in (B, S) order through the trainer's merged lookup.
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
from ctr_recommendation_tpu.models import autoint as jax_autoint
from ctr_recommendation_tpu.models import build_model as jax_build_model
from ctr_recommendation_tpu.models import registry as jax_registry
from ctr_recommendation_tpu.models import trunk as jax_trunk
from ctr_recommendation_tpu.ops import attention as jax_attention
from ctr_recommendation_tpu.ops import cin as jax_cin
from ctr_recommendation_tpu.ops import crossnet as jax_crossnet
from ctr_recommendation_tpu.parallel.mesh import single_device_mesh
from ctr_recommendation_tpu.training import Trainer as JaxTrainer
from ctr_recommendation_tpu.training import bce_with_logits as jax_bce
from ctr_recommendation_tpu.training import sparse as jax_sparse
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.data import ItemStore, TableData
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm
from ctr_recommendation_tpu_torch.models import autoint as pt_autoint
from ctr_recommendation_tpu_torch.models import available_models, get_model
from ctr_recommendation_tpu_torch.models import trunk as pt_trunk
from ctr_recommendation_tpu_torch.ops import attention as pt_attention
from ctr_recommendation_tpu_torch.ops import cin as pt_cin
from ctr_recommendation_tpu_torch.ops import crossnet as pt_crossnet
from ctr_recommendation_tpu_torch.tools import jax_bridge
from ctr_recommendation_tpu_torch.training import Trainer, bce_with_logits
from ctr_recommendation_tpu_torch.training import sparse
from ctr_recommendation_tpu_torch.utils.tree import tree_map
from tests.conftest import make_batch
from tests.test_torch_sparse import STRATEGIES, _close, _labeled, _port_trainer, _sparse_exp
from tests.test_torch_training import _synthetic_split

torch.set_num_threads(2)

ZOO = ("din", "xdeepfm", "finalmlp", "dcnv2", "deepfm", "autoint", "masknet", "pnn", "dlrm")
# the zoo's widths cut to the tiny experiment's (E=16, F=6, tower (32, 16))
TINY = dict(cin_layer_units=(8, 8), finalmlp_stream1_units=(32, 16),
            finalmlp_stream2_units=(24, 16), finalmlp_num_heads=4, masknet_block_dim=16,
            din_att_hidden_units=(16, 8))
FP32 = dict(rtol=1e-4, atol=1e-5)
# bf16, port vs JAX, |d| <= tol * max(1, |JAX's|). The ops alone: one bf16
# ulp (2^-8 to 2^-7 relative), for a sum taken in another order; on the CPU
# they read bit for bit equal. The eval logits: 2^-6. Both packages round
# the same operations to bf16 at the same points, but XLA fuses the
# BatchNorm's elementwise chain and rounds it once, and one ulp apart in a
# layer moves every later layer; over three batches the largest gap reads
# 0.0056 (dcnv2), finalmlp (fp32 after the trunk) and masknet (no
# BatchNorm) read 0, on the CPU.
BF16_OP_TOL = 2.0**-7
BF16_LOGIT_TOL = 2.0**-6


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def assert_bf16_close(got, want, tol):
    want = np.asarray(want, np.float32)
    gap = np.abs(got.float().numpy() - want) / np.maximum(1.0, np.abs(want))
    assert np.isfinite(want).all() and gap.max() <= tol, gap.max()


def test_the_registry_serves_every_jax_name():
    assert available_models() == jax_registry.available_models()
    assert set(ZOO) <= set(available_models())
    for name in available_models():
        assert get_model(name.upper()).SEQ_POOLING in ("mean", "attention", "din")
    with pytest.raises(KeyError, match="registered"):
        get_model("nope")


def _bridged(tiny_experiment, tiny_feature_map, model, precision="float32"):
    """(JAX experiment, module, params, state; the port's experiment, module,
    params, state), the weights the JAX init's (numpy trees on the JAX
    side). xDeepFM's zero-initialized CIN head is set to seeded values."""
    cfg = dataclasses.replace(
        tiny_experiment.model, model=model, use_pallas=False, net_dropout=0.0,
        tower_dtype="float32" if precision == "float32" else "compute", **TINY,
    )
    train = dataclasses.replace(tiny_experiment.train, compute_dtype=precision)
    exp = tiny_experiment.replace(model=cfg, train=train)
    module, params, state = jax_build_model(tiny_feature_map, cfg, jax.random.key(0))
    params, state = np_tree(params), np_tree(state)
    if model == "xdeepfm":
        rng = np.random.default_rng(17)
        for k, v in params["cin"]["out"].items():
            params["cin"]["out"][k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
    pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
    pparams, pstate = jax_bridge.params_from_jax(params, state, pt_build_fm(pexp.dataset),
                                                 pexp.model)
    return exp, module, params, state, pexp, get_model(model), pparams, pstate


@pytest.mark.parametrize("model", ZOO)
def test_train_step_loss_and_gradients_match_jax(tiny_experiment, tiny_feature_map, model):
    exp, module, params, state, pexp, pmodule, pparams, pstate = _bridged(
        tiny_experiment, tiny_feature_map, model)
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
    logits, got_state = pmodule.apply(
        pparams, pstate, pt_build_fm(pexp.dataset), pexp.model,
        {k: torch.from_numpy(v) for k, v in batch.items()}, train=True,
        compute_dtype=torch.float32, weight=torch.from_numpy(weight),
    )
    loss = bce_with_logits(logits, torch.from_numpy(labels), torch.from_numpy(weight))
    grads = torch.autograd.grad(loss, leaves)

    assert logits.dtype == torch.float32 and logits.shape == (48,)
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
    if model == "xdeepfm":  # the head is set: every filter's gradient is real
        for k in range(len(TINY["cin_layer_units"])):
            assert np.abs(flat_want[f"cin/filters/{k}"]).max() > 1e-3
    want_st = jax_bridge.flatten(np_tree(want_state))
    got_st = jax_bridge.flatten(got_state)
    assert sorted(got_st) == sorted(want_st)
    assert model != "masknet" or got_st == {}
    for path, g in got_st.items():
        np.testing.assert_allclose(g.numpy(), want_st[path], rtol=1e-5, atol=1e-6, err_msg=path)


def _off_init_stats(state, seed):
    """BatchNorm running statistics moved off (0, 1), the same on both sides."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, v in jax_bridge.flatten(state).items():
        out[path] = (rng.normal(0, 0.2, v.shape) if path.endswith("bn_mean")
                     else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
    return jax_bridge.unflatten(out) if out else state


@pytest.mark.parametrize("model", ZOO)
def test_bf16_eval_logits_match_jax(tiny_experiment, tiny_feature_map, model):
    exp, module, params, state, pexp, pmodule, pparams, _ = _bridged(
        tiny_experiment, tiny_feature_map, model, precision="bfloat16")
    state = _off_init_stats(state, 3)
    pstate = jax_bridge.params_from_jax(params, state, pt_build_fm(pexp.dataset),
                                        pexp.model)[1]
    batch = make_batch(np.random.default_rng(6), 64)
    want, _ = module.apply(params, state, tiny_feature_map, exp.model, batch,
                           compute_dtype=jnp.bfloat16)
    got, _ = pmodule.apply(pparams, pstate, pt_build_fm(pexp.dataset), pexp.model,
                           {k: torch.from_numpy(v) for k, v in batch.items()},
                           compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert_bf16_close(got, want, BF16_LOGIT_TOL)


def test_autoint_layers_run_in_fp32_under_a_bf16_trunk():
    """JAX's ``x @ wq`` promotes a bf16 x to fp32: the port's layers take
    it as fp32 explicitly, so their outputs are fp32 and equal to JAX's to
    fp32 noise, which a bf16 run of the same layers is not."""
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.normal(size=(32, 6, 16)), jnp.bfloat16)
    layers = [{k: (rng.normal(size=(16, 16)) * 0.3).astype(np.float32)
               for k in ("wq", "wk", "wv", "wres")} for _ in range(2)]
    want, got = x, torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    for layer in layers:
        want = jax_autoint._interact(layer, want, 2)
        got = pt_autoint.interact({k: torch.from_numpy(v) for k, v in layer.items()}, got, 2)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)

    def bf16_layer(layer, h):  # the control: the same layer on bf16 operands
        w = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in layer.items()}
        split = lambda t: t.reshape(32, 6, 2, 8).transpose(1, 2)  # noqa: E731
        q, k, v = (split(h @ w[n]) for n in ("wq", "wk", "wv"))
        a = torch.softmax(q @ k.transpose(-1, -2) / 8**0.5, dim=-1)
        return torch.relu((a @ v).transpose(1, 2).reshape(32, 6, 16) + h @ w["wres"])

    low = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    for layer in layers:
        low = bf16_layer(layer, low)
    assert not np.allclose(low.float().numpy(), np.asarray(want), **FP32)


# ----------------------------------------------------------------- the ops
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_din_pool_matches_jax(dtype):
    rng = np.random.default_rng(10)
    params = np_tree(jax_attention.din_init(jax.random.key(1), 16, (16, 8)))
    for layer in params["layers"][:-1]:  # slopes off their 0.25 start
        layer["alpha"] = rng.uniform(0.0, 0.5, layer["alpha"].shape).astype(np.float32)
    seq = rng.normal(size=(40, 8, 16)).astype(np.float32)
    ids = rng.integers(1, 50, size=(40, 8)).astype(np.int32)
    ids[rng.random((40, 8)) < 0.3] = 0
    ids[3] = 0  # an all-pad history
    target = rng.normal(size=(40, 16)).astype(np.float32)
    want = jax_attention.din_pool(params, jnp.asarray(seq, dtype), jnp.asarray(ids),
                                  jnp.asarray(target, dtype))
    got = pt_attention.din_pool(tree_map(torch.from_numpy, params),
                                torch.from_numpy(seq).to(getattr(torch, dtype)),
                                torch.from_numpy(ids),
                                torch.from_numpy(target).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (40, 16)
    assert not got[3].any()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    else:
        assert_bf16_close(got, want, BF16_OP_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trunk_din_branch_matches_jax(tiny_experiment, tiny_feature_map, dtype):
    """The history gathered in (B, S) order and pooled against item_id's
    field; an all-pad history gives a zero field."""
    cfg = dataclasses.replace(tiny_experiment.model, **TINY)
    params = np_tree(jax_trunk.init(jax.random.key(9), tiny_feature_map, cfg, seq_pooling="din"))
    batch = make_batch(np.random.default_rng(10), 32)
    batch["item_seq"][5] = 0
    want = jax_trunk.apply(params, tiny_feature_map, cfg, batch, seq_pooling="din",
                           compute_dtype=jnp.dtype(dtype))
    pexp = pt_serialize.from_json(jax_serialize.to_json(tiny_experiment.replace(model=cfg)))
    got = pt_trunk.apply(tree_map(torch.from_numpy, params), pt_build_fm(pexp.dataset),
                         pexp.model, {k: torch.from_numpy(v) for k, v in batch.items()},
                         seq_pooling="din", compute_dtype=getattr(torch, dtype))
    assert got.shape == (32, 6, 16) and got.dtype == getattr(torch, dtype)
    assert not got[5, -1].any()  # item_seq is the last field
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    else:
        assert_bf16_close(got, want, BF16_OP_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("units", [(8, 8), (8, 12, 4)])
def test_cin_matches_jax(units, dtype):
    rng = np.random.default_rng(11)
    params = np_tree(jax_cin.init(jax.random.key(2), 6, units))
    params["out"] = {k: rng.normal(0, 0.5, v.shape).astype(np.float32)
                     for k, v in params["out"].items()}
    x0 = rng.normal(size=(32, 6, 16)).astype(np.float32)
    want = jax_cin.apply(params, jnp.asarray(x0, dtype))
    got = pt_cin.apply(tree_map(torch.from_numpy, params),
                       torch.from_numpy(x0).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (32, 1)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    else:
        assert_bf16_close(got, want, BF16_OP_TOL)


def test_cin_init_matches_the_jax_tree():
    want = jax_bridge.flatten(np_tree(jax_cin.init(jax.random.key(3), 6, (8, 12))))
    got = jax_bridge.flatten(pt_cin.init(torch.Generator().manual_seed(0), 6, (8, 12)))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert not got["out/w"].any() and not got["out/b"].any()
    bound = (6.0 / (6 * 6 + 8)) ** 0.5  # Glorot-uniform over the (H_prev * F) fan-in
    assert 0.9 * bound < got["filters/0"].abs().max() <= bound


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crossnet_matches_jax(dtype):
    rng = np.random.default_rng(12)
    params = np_tree(jax_crossnet.init(jax.random.key(4), 48, 3))
    x0 = rng.normal(size=(32, 48)).astype(np.float32)
    want = jax_crossnet.apply(params, jnp.asarray(x0, dtype))
    got = pt_crossnet.apply(tree_map(torch.from_numpy, params),
                            torch.from_numpy(x0).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    else:
        assert_bf16_close(got, want, BF16_OP_TOL)


# ------------------------------------------------------ the slice as whole
@pytest.mark.parametrize("model", ["din", "xdeepfm", "finalmlp"])
def test_fit_on_device_matches_jax(tiny_experiment, tmp_path, model):
    train, valid, ids, emb = _synthetic_split(1024, 512)
    cfg = dataclasses.replace(tiny_experiment.model, model=model, use_pallas=False,
                              net_dropout=0.0, tower_dtype="float32", **TINY)
    tc = dataclasses.replace(
        tiny_experiment.train, compute_dtype="float32", shuffle=False, epochs=2,
        checkpoint_dir=str(tmp_path / "jax"), eval_batch_size=256, log_every=10_000,
        async_checkpointing=False, tensorboard=False)
    exp = tiny_experiment.replace(model=cfg, train=tc)
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


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_din_sparse_train_step_matches_jax(tiny_experiment, tmp_path, monkeypatch, strategy):
    """Two rowwise_adagrad steps from bridged weights: DIN's history is
    looked up in (B, S) order, through the merged lookup of the item table
    (masked-dense) or its row buffer (gathered)."""
    monkeypatch.setattr(jax_sparse, "GATHERED_MIN_VOCAB_RATIO", STRATEGIES[strategy])
    monkeypatch.setattr(sparse, "GATHERED_MIN_VOCAB_RATIO", STRATEGIES[strategy])
    base = tiny_experiment.replace(model=dataclasses.replace(tiny_experiment.model, **TINY))
    exp = _sparse_exp(base, "rowwise_adagrad", "din", checkpoint_dir=str(tmp_path / "jax"))
    jt = JaxTrainer(exp, mesh=single_device_mesh(), total_steps=10, log_fn=lambda s: None)
    pt = _port_trainer(exp, jt, tmp_path / "pt", total_steps=10)
    multi = pt._multi_feature_plan({k: torch.from_numpy(v) for k, v in
                                    make_batch(np.random.default_rng(0), 64).items()})
    assert [(n, tuple(i.shape)) for n, i in multi["item_id"]] == [
        ("item_id", (64,)), ("item_seq", (64, 8))]
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
    for t, st in pt.state.table_opt_state.items():
        for k, v in st.items():
            _close(v, want_t[t][k], f"{t}/{k}")
    assert pt.state.step == int(jt.state.step) == 2
