"""The port's reference-checkpoint import (tools/torch_import.py) against the
JAX package's, on the CPU.

A seeded state_dict with the reference MM_FiBiNET's names and layout (torch
Linear weights (out, in), BatchNorm running statistics and
``num_batches_tracked``, the dead ``user_emb``) is built at the tiny
experiment's widths by ``chip_smoke.reference_state_dict``, the function
phase 7c uses at full width, so no reference checkout is needed. Both
imports must give every leaf the checkpoint carries exactly (the tables'
checkpoint rows; the padded rows past them keep each side's own init and
are left out), the same BatchNorm state, and an fp32 forward within the
port's fp32 Predictor bar (rtol 1e-4, atol 1e-5,
tests/test_torch_predictor.py). Each error case raises the same exception
with the same message on both sides."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.data import ItemStore as JaxItemStore
from ctr_recommendation_tpu.inference import Predictor as JaxPredictor
from ctr_recommendation_tpu.tools.torch_import import import_state_dict as jax_import
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.data import ItemStore
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm
from ctr_recommendation_tpu_torch.inference import Predictor
from ctr_recommendation_tpu_torch.tools import jax_bridge
from ctr_recommendation_tpu_torch.tools.torch_import import (
    import_state_dict,
    load_checkpoint,
    strip_module_prefix,
)
from tests.conftest import make_batch

torch.set_num_threads(2)


def _exps(tiny_experiment, btype="all", model="mm_fibinet"):
    cfg = dataclasses.replace(tiny_experiment.model, model=model, bilinear_type=btype,
                              use_pallas=True, tower_dtype="float32")
    train = dataclasses.replace(tiny_experiment.train, compute_dtype="float32")
    exp = tiny_experiment.replace(model=cfg, train=train)
    return exp, pt_serialize.from_json(jax_serialize.to_json(exp))


def reference_state_dict(pexp, seed: int = 0) -> dict[str, torch.Tensor]:
    """``chip_smoke.reference_state_dict`` at ``pexp``'s widths."""
    return chip_smoke.reference_state_dict(torch, pexp, pt_build_fm(pexp.dataset), seed)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _flat(params, state):
    out = {f"params/{k}": np.asarray(v) for k, v in jax_bridge.flatten(params).items()}
    out.update({f"model_state/{k}": np.asarray(v) for k, v in jax_bridge.flatten(state).items()})
    return out


def _assert_same_import(got, want, sd):
    """Every leaf equal, the tables only in the checkpoint's rows."""
    rows = {"params/trunk/tables/item_id": sd["item_emb.weight"].shape[0],
            "params/trunk/tables/likes_level": sd["cate_emb.weight"].shape[0]}
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == np.float32, (k, g.shape, w.shape, g.dtype)
        n = rows.get(k, len(w))
        np.testing.assert_array_equal(g[:n], w[:n], err_msg=k)


@pytest.mark.parametrize("btype", ["all", "each"])
def test_import_equals_the_jax_import_leaf_for_leaf(tiny_experiment, btype):
    exp, pexp = _exps(tiny_experiment, btype)
    sd = reference_state_dict(pexp, seed=3)
    pparams, pstate = import_state_dict(sd, pexp)
    for t in jax_bridge.flatten({"p": pparams, "s": pstate}).values():
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.device.type == "cpu"
    jparams, jstate = jax_import(sd, exp)
    got = _flat(pparams, pstate)
    _assert_same_import(got, _flat(_np_tree(jparams), _np_tree(jstate)), sd)
    # the transposes, read straight off the state_dict
    np.testing.assert_array_equal(got["params/mlp/layers/0/linear/w"], sd["mlp.0.weight"].T)
    np.testing.assert_array_equal(got["params/senet/fc2/w"], sd["senet.excitation.2.weight"].T)
    np.testing.assert_array_equal(got["model_state/mlp/layers/1/bn_var"],
                                  sd["mlp.5.running_var"])
    if btype == "all":
        np.testing.assert_array_equal(got["params/bilinear/w"], sd["bilinear.W"])
    # the bridge takes the imported tree as it takes a JAX export
    fm = pt_build_fm(pexp.dataset)
    again, again_state = jax_bridge.params_from_jax(
        jax_bridge.unflatten({k: v.numpy() for k, v in jax_bridge.flatten(pparams).items()}),
        jax_bridge.unflatten({k: v.numpy() for k, v in jax_bridge.flatten(pstate).items()}),
        fm, pexp.model)
    _assert_same_import(_flat(again, again_state), got, sd)


def _item_store(batch):
    """An item store holding exactly the batch's item vectors."""
    mm = np.zeros((200, 24), np.float32)
    mm[batch["item_id"]] = batch["item_emb_d128"]
    return ItemStore.from_arrays(np.arange(200), mm)


def test_imported_forward_agrees_with_the_jax_import(tiny_experiment, tmp_path):
    exp, pexp = _exps(tiny_experiment)
    sd = reference_state_dict(pexp, seed=5)
    path = str(tmp_path / "FiBiNET_best.pth")
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)  # DataParallel-style keys
    pparams, pstate = load_checkpoint(path, pexp)
    jparams, jstate = jax_import(sd, exp)
    batch = make_batch(np.random.default_rng(6), 64)
    store = _item_store(batch)
    want = np.asarray(JaxPredictor(exp, jparams, jstate,
                                   item_store=JaxItemStore(store.emb, store.known_mask))(batch))
    for fold_bn in (True, False):
        pred = Predictor(pexp, pparams, pstate, device="cpu", fold_bn=fold_bn, item_store=store)
        got = pred(batch).numpy()
        assert got.shape == (64,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome compared is the exception itself
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", ["module_prefix", "unknown_key", "missing_key", "wrong_e",
                                  "not_mm_fibinet"])
def test_import_cases_as_the_jax_import(tiny_experiment, case):
    exp, pexp = _exps(tiny_experiment, model="fibinet" if case == "not_mm_fibinet" else
                      "mm_fibinet")
    sd = reference_state_dict(_exps(tiny_experiment)[1], seed=9)
    base = _flat(*import_state_dict(sd, _exps(tiny_experiment)[1]))
    if case == "module_prefix":
        sd = {f"module.{k}": v for k, v in sd.items()}
        assert strip_module_prefix(sd).keys() == reference_state_dict(pexp).keys()
    elif case == "unknown_key":
        sd = {**sd, "extra.weight": torch.zeros(2)}
    elif case == "missing_key":
        sd = {k: v for k, v in sd.items() if k != "mlp.8.bias"}
    elif case == "wrong_e":
        e = pexp.model.embedding_dim
        sd = {**sd, "item_emb.weight": torch.zeros(sd["item_emb.weight"].shape[0], e + 8)}
    got = _outcome(lambda: import_state_dict(sd, pexp))
    want = _outcome(lambda: jax_import(sd, exp))
    expected = {
        "module_prefix": None,
        "unknown_key": (ValueError, "unconsumed checkpoint keys: ['extra.weight']"),
        "missing_key": (KeyError, "\"checkpoint missing 'mlp.8.bias'\""),
        "wrong_e": (ValueError, f"checkpoint embedding_dim {pexp.model.embedding_dim + 8} != "
                                f"config {pexp.model.embedding_dim}"),
        "not_mm_fibinet": (ValueError,
                           "reference checkpoints are MM_FiBiNET; experiment has 'fibinet'"),
    }[case]
    assert got == want == expected
    if case == "module_prefix":
        _assert_same_import(_flat(*import_state_dict(sd, pexp)), base,
                            strip_module_prefix(sd))
    if case == "unknown_key":  # not strict: imported all the same
        _assert_same_import(_flat(*import_state_dict(sd, pexp, strict=False)), base, sd)
