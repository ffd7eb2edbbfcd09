"""The port's CLIs chained on parquet roots, on the CPU (``--device cpu``):
the counterpart of ``chip_smoke.py`` phase 7f, at a small size.

(a) The port's predict CLI against the JAX predict CLI
    (``ctr_recommendation_tpu/cli/predict.py``) on one checkpoint that the
    JAX package trained, bridged with ``tools/jax_bridge.save``, the test
    split written in several row groups: the port's default path (the
    overlapped pipeline) and ``--stream`` each write the JAX CSV's IDs, and
    probabilities within ``PREDICT_TOL``: 1e-5 at fp32 (the same fp32
    arithmetic summed in another order) and ``CPU_TOL`` = 2e-2 at bf16 (each
    side rounds the trunk and tower to bf16 at its own points; the
    Predictor's bar).

(b) The chain phase 7f runs on the card, run once here on a synthetic root
    whose train and test splits lie in several row groups: Task 1 (the item
    embeddings CLI, hash encoder) writes the root's item_info; the train
    CLI trains one epoch, ``--resume`` runs the second from the first's
    resume point (the restored state that resume point's, bit for bit),
    ``--stream`` trains a fresh run over the row groups; both predict paths
    write byte-identical CSVs, those of ``score_table`` over the split;
    evaluate's ``[eval]`` line is ``evaluate()``'s; validate_dataset exits
    0; ``build_service`` answers a request with the Predictor's scores.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import threading
import urllib.request

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

torch.set_num_threads(2)

CPU_TOL = 2e-2  # chip_smoke.py's: bf16 probabilities of two implementations
PREDICT_TOL = {"float32": 1e-5, "bfloat16": CPU_TOL}
ROW_GROUP = 64  # rows a row group of the rewritten splits


def _run(main, argv):
    """``main(argv)``, its standard output captured: (rc, its lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


def _row_groups(path: str, rows: int = ROW_GROUP) -> int:
    """Rewrite the parquet file at ``path`` in row groups of ``rows``;
    returns their count."""
    pq.write_table(pq.read_table(path), path, row_group_size=rows)
    return pq.ParquetFile(path).metadata.num_row_groups


def _csv(path: str) -> tuple[np.ndarray, np.ndarray]:
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "ID,Task2"
    ids, probs = zip(*(ln.split(",") for ln in lines[1:]))
    return np.asarray(ids, np.int64), np.asarray(probs, np.float64)


# ------------------------------------------- (a) predict against the JAX CLI
@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A tiny synthetic root (the test split in row groups of ROW_GROUP), an
    mm_fibinet checkpoint trained one epoch by the JAX package, and its best
    export bridged to the port's .npz."""
    from ctr_recommendation_tpu.cli.train import run_training
    from ctr_recommendation_tpu.config import microlens_experiment
    from ctr_recommendation_tpu.config.loader import microlens_features
    from ctr_recommendation_tpu.data import write_synthetic_dataset
    from ctr_recommendation_tpu.training import Trainer
    from ctr_recommendation_tpu_torch.tools import jax_bridge

    tmp = tmp_path_factory.mktemp("cli_chain_jax")
    root, ckpt = str(tmp / "data"), str(tmp / "ckpt")
    write_synthetic_dataset(root, num_rows=3000, valid_frac=0.2, test_frac=0.1, num_items=199,
                            num_users=40, max_len=8, mm_dim=24, seed=1)
    assert _row_groups(os.path.join(root, "test.parquet")) == 300 // ROW_GROUP + 1
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


@pytest.fixture(scope="module")
def jax_predictions(jax_checkpoint):
    """Per precision: the checkpoint directory serving at it (the same
    trained weights; the fused scoring path) and the JAX predict CLI's CSV
    (default path) on it."""
    from ctr_recommendation_tpu.cli.predict import main as jax_main

    tmp, root, ckpt, _ = jax_checkpoint
    out = {}
    for precision in PREDICT_TOL:
        served = tmp / f"ckpt_{precision}"
        shutil.copytree(ckpt, served)
        cfg = json.loads((served / "experiment.json").read_text())
        cfg["train"]["compute_dtype"] = precision
        cfg["model"]["tower_dtype"] = "float32" if precision == "float32" else "compute"
        cfg["model"]["use_pallas"] = True
        (served / "experiment.json").write_text(json.dumps(cfg))
        jout = tmp / f"jax_out_{precision}"
        rc, _ = _run(jax_main, ["--data-root", root, "--checkpoint-dir", str(served),
                                "--out-dir", str(jout), "--batch-size", "128"])
        assert rc == 0
        out[precision] = (str(served), _csv(str(jout / "prediction_fibinet.csv")))
    return out


@pytest.mark.parametrize("flags", [[], ["--stream"]], ids=["pipeline", "stream"])
@pytest.mark.parametrize("precision", list(PREDICT_TOL))
def test_predict_cli_matches_the_jax_predict_cli(jax_checkpoint, jax_predictions, precision,
                                                  flags, tmp_path):
    from ctr_recommendation_tpu_torch.cli.predict import main as port_main

    _, root, _, weights = jax_checkpoint
    served, (want_ids, want) = jax_predictions[precision]
    rc, lines = _run(port_main, ["--data-root", root, "--checkpoint-dir", served, "--out-dir",
                                 str(tmp_path), "--weights", weights, "--batch-size", "128",
                                 "--device", "cpu", *flags])
    assert rc == 0 and lines[0] == "[data] test 300 rows"
    ids, got = _csv(str(tmp_path / "prediction_fibinet.csv"))
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(ids, np.arange(300))
    assert np.abs(got - want).max() <= PREDICT_TOL[precision]
    assert ((got > 0) & (got < 1)).all()


# ------------------------------------------------------------- (b) the chain
def _item_feature(path: str, n: int) -> np.ndarray:
    """item_feature.parquet of items 1..n, seeded titles, tags and levels;
    returns the mask of items with no title and no tags."""
    rng = np.random.default_rng(3)
    blank = rng.random(n) < 0.05
    titles = ["" if b else " ".join(f"w{w}" for w in rng.integers(0, 50, rng.integers(2, 6)))
              for b in blank]
    tags = [[] if b else [f"t{t}" for t in rng.integers(0, 9, rng.integers(0, 3))]
            for b in blank]
    pq.write_table(pa.table({
        "item_id": pa.array(np.arange(1, n + 1, dtype=np.int64)),
        "item_title": pa.array(titles, pa.string()),
        "item_tags": pa.array(tags, pa.list_(pa.string())),
        "likes_level": pa.array(rng.integers(0, 11, n)),
        "views_level": pa.array(rng.integers(0, 11, n)),
    }), path)
    return blank


N_ITEMS = 199
TRAIN_FLAGS = ["--embedding-dim", "16", "--batch-size", "128", "--device", "cpu"]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Phase 7f's chain on the CPU; returns what each stage left."""
    from ctr_recommendation_tpu_torch.cli import evaluate as cli_evaluate
    from ctr_recommendation_tpu_torch.cli import item_embeddings as cli_items
    from ctr_recommendation_tpu_torch.cli import predict as cli_predict
    from ctr_recommendation_tpu_torch.cli import train as cli_train
    from ctr_recommendation_tpu_torch.cli import validate_dataset as cli_validate
    from ctr_recommendation_tpu_torch.data import write_synthetic_dataset
    from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten
    from ctr_recommendation_tpu_torch.training import Trainer

    tmp = tmp_path_factory.mktemp("cli_chain")
    root = str(tmp / "data")
    write_synthetic_dataset(root, num_rows=3000, num_items=N_ITEMS, num_users=40, seed=2,
                            signal="high")
    res = {"root": root, "groups": {n: _row_groups(os.path.join(root, f"{n}.parquet"))
                                    for n in ("train", "test")}}
    # Task 1: the root's item_info from an item_feature.parquet
    features = str(tmp / "item_feature.parquet")
    res["blank"] = _item_feature(features, N_ITEMS)
    info = os.path.join(root, "item_info.parquet")
    res["task1"] = _run(cli_items.main, ["--item-feature", features, "--output", info,
                                         "--encoder", "hash", "--device", "cpu"])
    # train one epoch, then --resume the second, observing _restore
    ckpt = str(tmp / "ckpt")
    res["ckpt"] = ckpt
    res["train"] = _run(cli_train.main, ["--data-root", root, "--epochs", "1",
                                         "--checkpoint-dir", ckpt, *TRAIN_FLAGS])
    res["resume_point"] = torch.load(os.path.join(ckpt, "ckpt_1.pt"), weights_only=True)
    restore, restored = Trainer._restore, {}

    def observed(self, payload):
        restore(self, payload)
        restored.update({k: {p: t.detach().clone() if torch.is_tensor(t) else t
                             for p, t in flatten(getattr(self.state, k)).items()}
                         for k in ("params", "model_state", "opt_state", "table_opt_state")},
                        step=self.state.step, device=self.device)

    Trainer._restore = observed
    try:
        res["resume"] = _run(cli_train.main, ["--data-root", root, "--epochs", "2", "--resume",
                                              "--checkpoint-dir", ckpt, *TRAIN_FLAGS])
    finally:
        Trainer._restore = restore
    res["restored"] = restored
    # --stream: a fresh run over the train split's row groups
    res["stream_ckpt"] = str(tmp / "ckpt_stream")
    res["stream"] = _run(cli_train.main, ["--data-root", root, "--epochs", "1", "--stream",
                                          "--checkpoint-dir", res["stream_ckpt"], *TRAIN_FLAGS])
    # predict: both paths
    for name, flags in (("predict", []), ("predict_stream", ["--stream"])):
        out = str(tmp / name)
        res[name] = _run(cli_predict.main, ["--data-root", root, "--checkpoint-dir", ckpt,
                                            "--out-dir", out, "--device", "cpu",
                                            "--batch-size", "128", *flags])
        res[name + "_out"] = out
    # evaluate, the evaluate() call it makes observed
    evaluate, seen = cli_evaluate.evaluate, {}

    def observed_evaluate(*a, **kw):
        out = evaluate(*a, **kw)
        seen.update(out)
        return out

    cli_evaluate.evaluate = observed_evaluate
    try:
        res["evaluate"] = _run(cli_evaluate.main, ["--data-root", root, "--checkpoint-dir", ckpt,
                                                   "--gauc-col", "user_id", "--batch-size",
                                                   "128", "--device", "cpu"])
    finally:
        cli_evaluate.evaluate = evaluate
    res["evaluated"] = seen
    res["validate"] = _run(cli_validate.main, ["--data-root", root])
    return res


def _predictor(res):
    """The Predictor the CLIs build on the chain's checkpoint, on the CPU."""
    from ctr_recommendation_tpu_torch.config import serialize
    from ctr_recommendation_tpu_torch.config.schema import MeshConfig
    from ctr_recommendation_tpu_torch.data import ItemStore
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.inference import Predictor
    from ctr_recommendation_tpu_torch.tools import jax_bridge

    root, ckpt = res["root"], res["ckpt"]
    exp = serialize.load(os.path.join(ckpt, "experiment.json"))
    exp = exp.replace(dataset=dataclasses.replace(
        exp.dataset, data_root=root, item_info=os.path.join(root, "item_info.parquet")),
        mesh=MeshConfig())
    fm = build_feature_map(exp.dataset)
    params, state = jax_bridge.params_from_jax(
        *jax_bridge.load(os.path.join(ckpt, "best", "export.npz")), fm, exp.model)
    return Predictor(exp, params, state, device="cpu",
                     item_store=ItemStore.from_parquet(exp.dataset.item_info))


def test_chain_task1_writes_the_roots_item_info(chain):
    rc, lines = chain["task1"]
    assert rc == 0 and lines[-1].endswith(f"{N_ITEMS} items, 128-d item_emb_d128")
    table = pq.read_table(os.path.join(chain["root"], "item_info.parquet"))
    np.testing.assert_array_equal(table.column("item_id").to_numpy(), np.arange(1, N_ITEMS + 1))
    emb = np.asarray(table.column("item_emb_d128").to_pylist(), np.float64)
    assert emb.shape == (N_ITEMS, 128)
    np.testing.assert_array_equal(emb.astype(np.float32).astype(np.float64), emb)  # float32 rows
    blank = chain["blank"]
    assert blank.any() and not emb[blank].any()
    assert np.abs(np.linalg.norm(emb[~blank], axis=1) - 1).max() <= 1e-5


def test_chain_resume_restores_the_resume_point_bit_for_bit(chain):
    from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten

    rc, lines = chain["resume"]
    assert rc == 0 and any(ln.startswith("[resume] epoch 1 step ") for ln in lines)
    assert not any(ln.startswith("[epoch 1]") for ln in lines)  # only epoch 2 ran
    got, want = chain["restored"], chain["resume_point"]
    assert got["step"] == want["step"] > 0 and got["device"].type == "cpu"
    n = 0
    for key in ("params", "model_state", "opt_state", "table_opt_state"):
        ref = flatten(want[key])
        assert sorted(got[key]) == sorted(ref), key
        for p, b in ref.items():
            a = got[key][p]
            if torch.is_tensor(b):
                n += 1
                assert a.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a, b), p
            else:
                assert a == b, p
    assert n > 10
    ckpt = chain["ckpt"]
    assert os.path.exists(os.path.join(ckpt, "ckpt_2.pt"))
    with open(os.path.join(ckpt, "metrics.csv")) as f:
        assert [float(ln.split(",")[0]) for ln in f.read().splitlines()[1:]] == [1.0, 2.0]


def test_chain_stream_trains_over_row_groups(chain):
    rc, lines = chain["stream"]
    assert chain["groups"]["train"] > 1
    assert rc == 0 and any(ln.startswith("[epoch 1] loss") for ln in lines)
    ckpt = chain["stream_ckpt"]
    assert os.path.exists(os.path.join(ckpt, "best", "export.npz"))
    assert os.path.exists(os.path.join(ckpt, "ckpt_1.pt"))


def test_chain_predict_paths_write_score_tables_bytes(chain):
    from ctr_recommendation_tpu_torch.data import load_split
    from ctr_recommendation_tpu_torch.inference.submission import HEADER, format_rows

    assert chain["groups"]["test"] > 1
    raw = {}
    for name in ("predict", "predict_stream"):
        rc, lines = chain[name]
        assert rc == 0 and lines[0] == "[data] test 300 rows"
        with open(os.path.join(chain[name + "_out"], "prediction_fibinet.csv"), "rb") as f:
            raw[name] = f.read()
    assert raw["predict"] == raw["predict_stream"]
    pred = _predictor(chain)
    probs = pred.score_table(load_split(os.path.join(chain["root"], "test.parquet"), pred.fm),
                             128)
    assert raw["predict"] == (HEADER + format_rows(probs)).encode()


def test_chain_evaluate_prints_evaluates_metrics(chain):
    from ctr_recommendation_tpu_torch.cli.evaluate import eval_line, evaluate
    from ctr_recommendation_tpu_torch.data import load_split

    rc, lines = chain["evaluate"]
    assert rc == 0
    pred = _predictor(chain)
    want = evaluate(pred, load_split(os.path.join(chain["root"], "valid.parquet"), pred.fm),
                    batch_size=128, gauc_col="user_id")
    assert lines[-1] == eval_line(want, "user_id")
    assert all(chain["evaluated"][k] == want[k] for k in ("rows", "auc", "logloss", "gauc"))
    with open(os.path.join(chain["ckpt"], "best", "metric.json")) as f:
        assert abs(want["auc"] - json.load(f)["metric"]) < 2e-3  # the served-AUC bar


def test_chain_validate_exits_0(chain):
    rc, lines = chain["validate"]
    assert rc == 0 and lines[-1].startswith("PASSED")


def test_chain_serve_answers_with_the_predictors_scores(chain):
    from ctr_recommendation_tpu_torch.cli.serve import build_argparser, build_service
    from ctr_recommendation_tpu_torch.data import load_split
    from ctr_recommendation_tpu_torch.serving import make_http_server

    args = build_argparser().parse_args(["--data-root", chain["root"], "--checkpoint-dir",
                                         chain["ckpt"], "--port", "0", "--buckets", "16,64",
                                         "--device", "cpu"])
    service = build_service(args)
    service.warmup()
    server = make_http_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        pred = _predictor(chain)
        test = load_split(os.path.join(chain["root"], "test.parquet"), pred.fm)
        idx = np.arange(5, 22)
        rows = []
        for i in idx:
            seq = test.columns["item_seq"][i]
            rows.append({"item_id": int(test.columns["item_id"][i]),
                         "likes_level": int(test.columns["likes_level"][i]),
                         "views_level": int(test.columns["views_level"][i]),
                         "item_seq": [int(s) for s in seq[seq != 0]]})
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/score",
            data=json.dumps({"rows": rows}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            got = np.asarray(json.loads(resp.read())["probs"], np.float32)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=60)
    want = pred.score_table(test, 128)[idx]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
