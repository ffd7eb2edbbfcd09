"""The port's serving path against the JAX package's, end to end (CPU).

JAX weights (its own init, BatchNorm stats moved off init by one train-mode
step) go through tools/jax_bridge.params_from_jax into the port's Predictor,
which runs with device="cpu". Probabilities must agree with the JAX
Predictor within 2e-2 and keep rank correlation above 0.995 (the
tests/test_predictor_fused.py bar for bf16), and to fp32 noise in fp32.
Also: the pipeline and the predict CLI on a tiny parquet split, and the
port's isolation from JAX.
"""

import ast
import csv
import dataclasses
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.inference import Predictor as JaxPredictor
from ctr_recommendation_tpu.models import build_model as jax_build_model
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.data import TableData
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm
from ctr_recommendation_tpu_torch.inference import Predictor
from ctr_recommendation_tpu_torch.ops.cuda.interaction import interaction_fwd
from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd
from ctr_recommendation_tpu_torch.tools import jax_bridge
from tests.conftest import make_batch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ctr_recommendation_tpu_torch"


def rank_corr(a, b):
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    return np.corrcoef(ra, rb)[0, 1]


def _setup(tiny_experiment, tiny_feature_map, btype, precision, hidden=None):
    """JAX experiment + weights, and the same in the port's form."""
    cfg = dataclasses.replace(
        tiny_experiment.model, use_pallas=True, bilinear_type=btype,
        tower_dtype="float32" if precision == "float32" else "compute",
        hidden_units=hidden or tiny_experiment.model.hidden_units,
    )
    train = dataclasses.replace(tiny_experiment.train, compute_dtype=precision)
    exp = tiny_experiment.replace(model=cfg, train=train)
    module, params, state = jax_build_model(tiny_feature_map, cfg, jax.random.key(0))
    batch = make_batch(np.random.default_rng(3), 64)
    _, state = module.apply(
        params, state, tiny_feature_map, cfg, batch, train=True, rng=jax.random.key(1)
    )
    pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    pparams, pstate = jax_bridge.params_from_jax(
        np_tree(params), np_tree(state), pt_build_fm(pexp.dataset), pexp.model
    )
    return exp, params, state, pexp, pparams, pstate


def _item_store(batch):
    """An item store holding exactly the batch's item vectors."""
    from ctr_recommendation_tpu_torch.data import ItemStore

    mm = np.zeros((200, 24), np.float32)
    mm[batch["item_id"]] = batch["item_emb_d128"]
    return ItemStore.from_arrays(np.arange(200), mm)


@pytest.mark.parametrize("btype, precision, hidden", [
    pytest.param(btype, precision, hidden,
                 id=f"{btype}-{precision}" + ("-" + "x".join(map(str, hidden)) if hidden else ""))
    # the tiny experiment's tower, then the recipe sweep's tower_768_384
    for hidden in (None, (768, 384))
    for precision in ("float32", "bfloat16") for btype in ("all", "each")])
def test_predictor_matches_jax(tiny_experiment, tiny_feature_map, btype, precision, hidden):
    exp, params, state, pexp, pparams, pstate = _setup(
        tiny_experiment, tiny_feature_map, btype, precision, hidden
    )
    from ctr_recommendation_tpu.data import ItemStore as JaxItemStore
    from ctr_recommendation_tpu.data import TableData as JaxTableData

    batch = make_batch(np.random.default_rng(4), 64)
    cols = {k: v for k, v in batch.items() if k != "item_emb_d128"}
    store = _item_store(batch)
    jpred = JaxPredictor(exp, params, state, item_store=JaxItemStore(store.emb, store.known_mask))
    want = np.asarray(jpred(batch))
    want_table = jpred.score_table(JaxTableData(cols, 64), batch_size=24)
    fused = Predictor(pexp, pparams, pstate, device="cpu", item_store=store)
    unfused = Predictor(pexp, pparams, pstate, device="cpu", fold_bn=False, item_store=store)
    assert fused.use_fused and not unfused.use_fused
    launches = (score_fwd.launches, interaction_fwd.launches)
    for pred in (fused, unfused):
        for got, ref in (
            (pred(batch).numpy(), want),
            (pred.score_table(TableData(cols, 64), batch_size=24), want_table),
        ):
            if precision == "float32":
                np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
            else:
                np.testing.assert_allclose(got, ref, atol=2e-2)
                assert rank_corr(got, ref) > 0.995
    assert (score_fwd.launches, interaction_fwd.launches) == launches  # CPU: plain versions


def test_score_table_matches_call_and_pads_the_tail(tiny_experiment, tiny_feature_map):
    _, _, _, pexp, pparams, pstate = _setup(tiny_experiment, tiny_feature_map, "all", "bfloat16")
    batch = make_batch(np.random.default_rng(5), 100)
    cols = {k: v for k, v in batch.items() if k != "item_emb_d128"}
    pred = Predictor(pexp, pparams, pstate, device="cpu", item_store=_item_store(batch))
    bulk = pred.score_table(TableData(cols, 100), batch_size=32)  # 4 batches, padded tail
    per_batch = np.concatenate(
        [pred({k: v[i : i + 32] for k, v in cols.items()}).numpy() for i in range(0, 100, 32)]
    )
    assert bulk.shape == (100,)
    np.testing.assert_allclose(bulk, per_batch, rtol=1e-6, atol=1e-7)


def _tiny_split(tmp_path, tiny_experiment):
    from ctr_recommendation_tpu.data import write_synthetic_dataset

    root = str(tmp_path / "data")
    write_synthetic_dataset(
        root, num_rows=3000, valid_frac=0.1, test_frac=0.4,
        num_items=199, max_len=8, mm_dim=24, seed=0,
    )
    return root


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["ID", "Task2"]
    ids = np.array([int(r[0]) for r in rows[1:]])
    probs = np.array([float(r[1]) for r in rows[1:]], np.float32)
    return ids, probs


def test_pipeline_matches_jax_pipeline(tmp_path, tiny_experiment, tiny_feature_map):
    """Tiny parquet -> both pipelines: same IDs, probabilities within the
    bf16 bar, the port's CSV equal to its own score_table exactly."""
    from ctr_recommendation_tpu.data import ItemStore as JaxItemStore
    from ctr_recommendation_tpu.inference import run_submission_pipeline as jax_pipeline
    from ctr_recommendation_tpu_torch.data import ItemStore
    from ctr_recommendation_tpu_torch.inference import run_submission_pipeline

    root = _tiny_split(tmp_path, tiny_experiment)
    exp, params, state, pexp, pparams, pstate = _setup(
        tiny_experiment, tiny_feature_map, "all", "bfloat16"
    )
    info, test = os.path.join(root, "item_info.parquet"), os.path.join(root, "test.parquet")
    jpred = JaxPredictor(exp, params, state, item_store=JaxItemStore.from_parquet(info))
    n_j, csv_j, _ = jax_pipeline(test, jpred, str(tmp_path / "jax"), batch_size=64, chunk_rows=256)
    pred = Predictor(pexp, pparams, pstate, device="cpu", item_store=ItemStore.from_parquet(info))
    n_p, csv_p, zip_p = run_submission_pipeline(
        test, pred, str(tmp_path / "port"), batch_size=64, chunk_rows=256
    )
    assert n_p == n_j == 1200
    ids_j, probs_j = _read_csv(csv_j)
    ids_p, probs_p = _read_csv(csv_p)
    np.testing.assert_array_equal(ids_p, np.arange(n_p))
    np.testing.assert_array_equal(ids_p, ids_j)
    np.testing.assert_allclose(probs_p, probs_j, atol=2e-2)
    assert rank_corr(probs_p, probs_j) > 0.995
    with zipfile.ZipFile(zip_p) as z:
        assert z.namelist() == ["prediction_fibinet.csv"]

    import pyarrow.parquet as pq

    from ctr_recommendation_tpu_torch.data.parquet import _pad_list_column

    tbl = pq.read_table(test)
    cols = {
        "likes_level": tbl["likes_level"].to_numpy().astype(np.int32),
        "views_level": tbl["views_level"].to_numpy().astype(np.int32),
        "item_id": tbl["item_id"].to_numpy().astype(np.int32),
        "item_seq": _pad_list_column(tbl["item_seq"], 8, 0),
    }
    np.testing.assert_array_equal(probs_p, pred.score_table(TableData(cols, tbl.num_rows), 64))


def test_pipeline_takes_decoded_chunks(tmp_path, tiny_experiment, tiny_feature_map):
    from ctr_recommendation_tpu_torch.inference import run_submission_pipeline

    _, _, _, pexp, pparams, pstate = _setup(tiny_experiment, tiny_feature_map, "each", "bfloat16")
    batch = make_batch(np.random.default_rng(6), 150)
    pred = Predictor(pexp, pparams, pstate, device="cpu", item_store=_item_store(batch))
    chunks = [
        {k: v[s : s + 64] for k, v in batch.items() if k != "item_emb_d128"}
        for s in range(0, 150, 64)
    ]
    n, csv_path, _ = run_submission_pipeline(chunks, pred, str(tmp_path), batch_size=32)
    ids, probs = _read_csv(csv_path)
    assert n == 150
    np.testing.assert_array_equal(ids, np.arange(150))
    want = np.concatenate([pred(c).numpy() for c in chunks])
    np.testing.assert_allclose(probs, want, rtol=1e-6, atol=1e-7)


def test_pad_list_column_keeps_last_events():
    import pyarrow as pa

    from ctr_recommendation_tpu_torch.data.parquet import _pad_list_column

    col = pa.array([[], [1], [1, 2, 3, 4, 5, 6], [7, 8]], type=pa.list_(pa.int64()))
    got = _pad_list_column(col, 4, 0)
    np.testing.assert_array_equal(
        got, [[0, 0, 0, 0], [0, 0, 0, 1], [3, 4, 5, 6], [0, 0, 7, 8]]
    )
    chunked = pa.chunked_array([col.slice(0, 2), col.slice(2)])
    np.testing.assert_array_equal(_pad_list_column(chunked, 4, 0), got)


def test_bridge_save_load_roundtrip(tmp_path, tiny_experiment, tiny_feature_map):
    _, params, state, pexp, pparams, pstate = _setup(
        tiny_experiment, tiny_feature_map, "each", "float32"
    )
    path = str(tmp_path / "w.npz")
    jax_bridge.save(path, jax.device_get(params), jax.device_get(state))
    lparams, lstate = jax_bridge.load(path)
    again, again_state = jax_bridge.params_from_jax(
        lparams, lstate, pt_build_fm(pexp.dataset), pexp.model
    )
    for k, v in jax_bridge.flatten(pparams).items():
        np.testing.assert_array_equal(jax_bridge.flatten(again)[k].numpy(), v.numpy())
    assert set(jax_bridge.flatten(again_state)) == {
        f"mlp/layers/{i}/{s}" for i in range(2) for s in ("bn_mean", "bn_var")
    }
    assert "w_each" in again["bilinear"] and "b" in again["senet"]["fc1"]
    bad = dict(lparams, bilinear={"w": np.zeros((16, 16), np.float32)})
    with pytest.raises(ValueError, match="tree mismatch"):
        jax_bridge.params_from_jax(bad, lstate, pt_build_fm(pexp.dataset), pexp.model)


def test_predict_cli_on_cpu(tmp_path, tiny_experiment, tiny_feature_map):
    from ctr_recommendation_tpu_torch.cli.predict import main

    root = _tiny_split(tmp_path, tiny_experiment)
    _, params, state, pexp, pparams, pstate = _setup(
        tiny_experiment, tiny_feature_map, "all", "bfloat16"
    )
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    pt_serialize.save(pexp, str(ckpt / "experiment.json"))
    weights = str(tmp_path / "w.npz")
    jax_bridge.save(weights, jax.device_get(params), jax.device_get(state))
    out = tmp_path / "out"
    rc = main([
        "--data-root", root, "--checkpoint-dir", str(ckpt), "--weights", weights,
        "--out-dir", str(out), "--batch-size", "64", "--device", "cpu",
    ])
    assert rc == 0
    ids, probs = _read_csv(out / "prediction_fibinet.csv")
    assert len(ids) == 1200 and np.isfinite(probs).all()
    assert (out / "submission_fibinet.zip").exists()
    with pytest.raises(SystemExit):
        main(["--data-root", root, "--checkpoint-dir", str(ckpt)])  # no --weights


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for module in ("ops/attention.py", "ops/cuda/sasrec_encoder.py", "models/sasrec_fibinet.py",
                   "ops/cuda/build.py", "ops/cuda/scoring.py", "ops/cuda/interaction.py",
                   "cli/evaluate.py", "cli/validate_dataset.py", "data/native/__init__.py",
                   "serving/__init__.py", "serving/collator.py", "serving/server.py",
                   "cli/serve.py", "parallel/__init__.py", "parallel/distributed.py",
                   "parallel/mesh.py", "parallel/sharding.py", "parallel/data_parallel.py",
                   "parallel/embedding.py", "version.py", "utils/seeding.py",
                   "utils/profiling.py", "utils/tb.py", "tools/torch_import.py",
                   "tools/item_embeddings.py", "cli/item_embeddings.py"):
        assert PORT / module in files, module
    assert (PORT / "csrc" / "sasrec_encoder.cu").exists()
    bad = [
        (str(f.relative_to(REPO)), m)
        for f in files
        for m in _imports(f)
        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "ctr_recommendation_tpu")
    ]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import ctr_recommendation_tpu_torch.inference.predictor\n"
        "import ctr_recommendation_tpu_torch.cli.predict\n"
        "import ctr_recommendation_tpu_torch.tools.jax_bridge\n"
        "import ctr_recommendation_tpu_torch.training.loop\n"
        "import ctr_recommendation_tpu_torch.cli.train\n"
        "import ctr_recommendation_tpu_torch.ops.attention\n"
        "import ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder\n"
        "import ctr_recommendation_tpu_torch.models.sasrec_fibinet\n"
        "import ctr_recommendation_tpu_torch.cli.evaluate\n"
        "import ctr_recommendation_tpu_torch.cli.validate_dataset\n"
        "import ctr_recommendation_tpu_torch.data.native\n"
        "import ctr_recommendation_tpu_torch.serving\n"
        "import ctr_recommendation_tpu_torch.cli.serve\n"
        "import ctr_recommendation_tpu_torch.parallel\n"
        "import ctr_recommendation_tpu_torch.parallel.data_parallel\n"
        "import ctr_recommendation_tpu_torch.parallel.distributed\n"
        "import ctr_recommendation_tpu_torch.parallel.embedding\n"
        "import ctr_recommendation_tpu_torch.utils\n"
        "import ctr_recommendation_tpu_torch.utils.tb\n"
        "import ctr_recommendation_tpu_torch.tools.torch_import\n"
        "import ctr_recommendation_tpu_torch.tools.item_embeddings\n"
        "import ctr_recommendation_tpu_torch.cli.item_embeddings\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'ctr_recommendation_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch, tiny_experiment, tiny_feature_map):
    from ctr_recommendation_tpu_torch.utils.device import resolve_device

    _, _, _, pexp, pparams, pstate = _setup(tiny_experiment, tiny_feature_map, "all", "bfloat16")
    from ctr_recommendation_tpu_torch.models import build_model

    sexp = pexp.replace(model=dataclasses.replace(pexp.model, model="sasrec_fibinet"))
    _, sparams, sstate = build_model(
        pt_build_fm(sexp.dataset), sexp.model, torch.Generator().manual_seed(0)
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(pexp, pparams, pstate)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(sexp, sparams, sstate)
    assert Predictor(sexp, sparams, sstate, device="cpu").use_fused
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    from ctr_recommendation_tpu_torch.cli.evaluate import main as evaluate_main
    from ctr_recommendation_tpu_torch.training.metrics import group_auc

    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_main(["--data-root", "/nonexistent"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        group_auc([1.0, 0.0], [0.7, 0.2], [3, 3])
    assert group_auc([1.0, 0.0], [0.7, 0.2], [3, 3], device="cpu") == 1.0
