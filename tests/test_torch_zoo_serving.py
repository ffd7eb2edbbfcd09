"""The zoo end to end on the CPU: serving against the JAX package, the CLIs.

* ``Predictor`` on a JAX export made into an ``.npz`` (``jax_bridge.save``,
  then ``load`` and ``params_from_jax``, BatchNorm statistics moved off init
  by one train-mode step), for each of the nine zoo models: the JAX
  Predictor's probabilities to fp32 noise (rtol 1e-4, atol 1e-5); only the
  "mlp" tower folded, as the JAX Predictor folds;
* the train CLI (with a resume) -> predict CLI round trip on the port's own
  export and the evaluate CLI, for xdeepfm (mean pooling), masknet (an
  empty model state, through resume points, the export and ``Predictor``)
  and deepfm (a 0-d bias, through Adam with L2, the global-norm clip, the
  resume points and the export);
* an unknown ``--model`` fails in each CLI before any data is loaded.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.data import ItemStore as JaxItemStore
from ctr_recommendation_tpu.inference import Predictor as JaxPredictor
from ctr_recommendation_tpu.models import build_model as jax_build_model
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.data import ItemStore
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm
from ctr_recommendation_tpu_torch.inference import Predictor
from ctr_recommendation_tpu_torch.tools import jax_bridge
from tests.conftest import make_batch
from tests.test_torch_zoo import TINY, ZOO

torch.set_num_threads(2)


@pytest.mark.parametrize("model", ZOO)
def test_predictor_on_a_bridged_npz_matches_jax(tiny_experiment, tiny_feature_map, tmp_path,
                                                model):
    cfg = dataclasses.replace(tiny_experiment.model, model=model, use_pallas=False,
                              tower_dtype="float32", **TINY)
    exp = tiny_experiment.replace(
        model=cfg, train=dataclasses.replace(tiny_experiment.train, compute_dtype="float32"))
    module, params, state = jax_build_model(tiny_feature_map, cfg, jax.random.key(0))
    _, state = module.apply(params, state, tiny_feature_map, cfg,
                            make_batch(np.random.default_rng(3), 64), train=True,
                            rng=jax.random.key(1))
    batch = make_batch(np.random.default_rng(4), 64)
    mm = np.zeros((200, 24), np.float32)
    mm[batch["item_id"]] = batch["item_emb_d128"]
    store = ItemStore.from_arrays(np.arange(200), mm)
    jpred = JaxPredictor(exp, params, state, item_store=JaxItemStore(store.emb, store.known_mask))
    want = np.asarray(jpred(batch))

    npz = str(tmp_path / "weights.npz")
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jax_bridge.save(npz, to_np(params), to_np(state))
    pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
    pparams, pstate = jax_bridge.params_from_jax(*jax_bridge.load(npz),
                                                 pt_build_fm(pexp.dataset), pexp.model)
    pred = Predictor(pexp, pparams, pstate, item_store=store, device="cpu")
    assert not pred.use_fused
    assert ("mlp" in pred.model_state) == (model not in ("finalmlp", "masknet"))
    if "mlp" in pred.model_state:  # folded: the tower has no BatchNorm left
        assert all("bn_scale" not in layer for layer in pred.params["mlp"]["layers"])
    if model == "finalmlp":  # its streams keep theirs, as in JAX
        assert "bn_scale" in pred.params["stream1"]["layers"][0]
    np.testing.assert_allclose(pred(batch).numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model", ["xdeepfm", "masknet", "deepfm"])
def test_train_predict_and_evaluate_clis(tmp_path, capsys, model):
    from ctr_recommendation_tpu_torch.cli.evaluate import main as evaluate_main
    from ctr_recommendation_tpu_torch.cli.predict import main as predict_main
    from ctr_recommendation_tpu_torch.cli.train import main as train_main
    from ctr_recommendation_tpu_torch.training.checkpoint import CheckpointManager

    data, ckpt, out = tmp_path / "data", tmp_path / "ckpt", tmp_path / "out"
    common = ["--synthetic", str(data), "--synthetic-rows", "3000", "--synthetic-items", "300",
              "--embedding-dim", "16", "--batch-size", "256", "--checkpoint-dir", str(ckpt),
              "--device", "cpu", "--model", model]
    assert train_main([*common, "--epochs", "1"]) == 0
    assert train_main([*common, "--epochs", "2", "--resume"]) == 0
    assert "[resume] epoch 1" in capsys.readouterr().out
    payload = CheckpointManager(str(ckpt)).restore(2)
    assert (payload["model_state"] == {}) == (model == "masknet")
    if model == "deepfm":  # the 0-d bias through Adam + L2, the clip, both files
        b = payload["params"]["first_order"]["b"]
        assert b.shape == () and b.item() != 0.0
        assert jax_bridge.load(str(ckpt / "best" / "export.npz"))[0]["first_order"]["b"] \
            .shape == ()
    assert predict_main(["--data-root", str(data), "--checkpoint-dir", str(ckpt),
                         "--out-dir", str(out), "--batch-size", "128", "--device", "cpu"]) == 0
    lines = (out / "prediction_fibinet.csv").read_text().splitlines()
    assert lines[0] == "ID,Task2" and len(lines) == 1 + 300
    probs = np.array([float(line.split(",")[1]) for line in lines[1:]])
    assert ((probs > 0) & (probs < 1)).all()
    capsys.readouterr()
    assert evaluate_main(["--data-root", str(data), "--checkpoint-dir", str(ckpt),
                          "--gauc-col", "user_id", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[eval] rows=") and "gAUC[user_id]=" in line
    auc = float(line.split("AUC=")[1].split()[0])
    metric = json.loads((ckpt / "best" / "metric.json").read_text())["metric"]
    assert abs(auc - metric) < 2e-3  # the served export gives the trainer's best AUC


@pytest.mark.parametrize("cli", ["train", "predict", "evaluate"])
def test_an_unknown_model_fails_before_data_load(cli, tmp_path):
    import importlib

    main = importlib.import_module(f"ctr_recommendation_tpu_torch.cli.{cli}").main
    weights = tmp_path / "w.npz"
    weights.write_bytes(b"")
    args = ["--data-root", str(tmp_path / "absent"), "--model", "nope", "--device", "cpu"]
    if cli != "train":
        args += ["--weights", str(weights), "--checkpoint-dir", str(tmp_path)]
    with pytest.raises(KeyError, match="unknown model 'nope'; registered"):
        main(args)
