"""The port's serve CLI on the CPU.

* The train CLI on a small synthetic data root, then ``build_service``
  (``--device cpu``) on its export: the service's scores are the port's
  Predictor's on that export, a request larger than the largest bucket
  included;
* ``--weights`` reads a ``jax_bridge.save``d .npz of a JAX init;
* the parser takes the JAX CLI's eight flags plus ``--device`` and
  ``--weights``, and the service needs CUDA unless told ``--device cpu``;
* ``python -m ctr_recommendation_tpu_torch.cli.serve`` answers a POST and
  stops on SIGINT, printing its stats.
"""

import json
import queue
import signal
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu_torch.cli.serve import build_argparser, build_service
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.data import ItemStore, load_split
from ctr_recommendation_tpu_torch.features import build_feature_map
from ctr_recommendation_tpu_torch.inference import Predictor
from ctr_recommendation_tpu_torch.tools import jax_bridge

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
WAIT_S = 120


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A data root and the port's train CLI's checkpoint on it."""
    from ctr_recommendation_tpu_torch.cli.train import main as train_main

    tmp = tmp_path_factory.mktemp("serve_cli")
    data, ckpt = tmp / "data", tmp / "ckpt"
    assert train_main([
        "--synthetic", str(data), "--synthetic-rows", "3000", "--synthetic-items", "300",
        "--epochs", "1", "--embedding-dim", "16", "--batch-size", "256",
        "--checkpoint-dir", str(ckpt), "--device", "cpu",
    ]) == 0
    return data, ckpt


def _rows(cols: dict, n: int) -> list[dict]:
    """The first ``n`` rows of the split's model columns as request rows."""
    rows = []
    for i in range(n):
        r = {k: int(cols[k][i]) for k in ("likes_level", "views_level", "item_id")}
        r["item_seq"] = cols["item_seq"][i].tolist()
        rows.append(r)
    return rows


def _split_head(data: Path, fm, n: int) -> dict:
    test = load_split(str(data / "test.parquet"), fm, include_label=False)
    return {k: v[:n] for k, v in test.columns.items()}


def test_service_scores_are_the_predictors_on_the_export(trained):
    data, ckpt = trained
    args = build_argparser().parse_args([
        "--data-root", str(data), "--checkpoint-dir", str(ckpt), "--device", "cpu",
        "--buckets", "16,64", "--max-wait-ms", "1"])
    service = build_service(args)
    try:
        exp = pt_serialize.load(str(ckpt / "experiment.json"))
        fm = build_feature_map(exp.dataset)
        params, state = jax_bridge.params_from_jax(
            *jax_bridge.load(str(ckpt / "best" / "export.npz")), fm, exp.model)
        pred = Predictor(exp, params, state, device="cpu",
                         item_store=ItemStore.from_parquet(str(data / "item_info.parquet")))
        assert service.model_name == "mm_fibinet" and service.collator.buckets == (16, 64)
        assert service.batcher.predictor.use_fused and service.batcher.max_wait_s == 0.001
        cols = _split_head(data, fm, 70)
        service.warmup()
        got = service.score(_rows(cols, 70))  # 64 + 6 rows: two dispatches
        np.testing.assert_allclose(got, pred(cols).numpy(), rtol=1e-6, atol=1e-7)
        assert service.stats()["batches_dispatched"] == 2
    finally:
        service.close()


def test_weights_flag_reads_a_bridged_jax_npz(tmp_path, tiny_experiment, tiny_feature_map):
    from tests.test_torch_predictor import _setup, _tiny_split

    root = Path(_tiny_split(tmp_path, tiny_experiment))
    _, params, state, pexp, pparams, pstate = _setup(
        tiny_experiment, tiny_feature_map, "each", "float32")
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    pt_serialize.save(pexp, str(ckpt / "experiment.json"))
    weights = str(tmp_path / "w.npz")
    jax_bridge.save(weights, jax.device_get(params), jax.device_get(state))
    service = build_service(build_argparser().parse_args([
        "--data-root", str(root), "--checkpoint-dir", str(ckpt), "--weights", weights,
        "--device", "cpu", "--buckets", "4,16"]))
    try:
        pred = Predictor(pexp, pparams, pstate, device="cpu",
                         item_store=ItemStore.from_parquet(str(root / "item_info.parquet")))
        cols = _split_head(root, pred.fm, 11)
        np.testing.assert_allclose(service.score(_rows(cols, 11)), pred(cols).numpy(),
                                   rtol=1e-6, atol=1e-7)
    finally:
        service.close()
    with pytest.raises(FileNotFoundError, match="no weights at"):
        build_service(build_argparser().parse_args([
            "--data-root", str(root), "--checkpoint-dir", str(ckpt), "--device", "cpu"]))


def test_parser_takes_the_jax_flags_and_device_and_weights(monkeypatch):
    p = build_argparser()
    flags = {s for a in p._actions for s in a.option_strings} - {"-h", "--help"}
    assert flags == {"--data-root", "--checkpoint-dir", "--model", "--host", "--port",
                     "--buckets", "--max-wait-ms", "--no-warmup", "--device", "--weights"}
    args = p.parse_args(["--data-root", "d", "--checkpoint-dir", "c", "--model", "din",
                         "--host", "0.0.0.0", "--port", "9000", "--buckets", "8,32",
                         "--max-wait-ms", "0.5", "--no-warmup", "--weights", "w.npz",
                         "--device", "cpu"])
    assert (args.model, args.port, args.buckets, args.max_wait_ms, args.no_warmup,
            args.weights, args.device) == ("din", 9000, "8,32", 0.5, True, "w.npz", "cpu")
    defaults = p.parse_args(["--data-root", "d"])
    assert (defaults.device, defaults.checkpoint_dir, defaults.model, defaults.host,
            defaults.port, defaults.max_wait_ms) == (
        "cuda", "checkpoints", "mm_fibinet", "127.0.0.1", 8080, 2.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_service(defaults)


def test_serve_module_answers_and_stops_on_sigint(trained):
    data, ckpt = trained
    proc = subprocess.Popen(
        [sys.executable, "-m", "ctr_recommendation_tpu_torch.cli.serve", "--data-root",
         str(data), "--checkpoint-dir", str(ckpt), "--device", "cpu", "--port", "0",
         "--buckets", "16,64"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True)
    reader.start()
    try:
        seen = []
        while not any("listening on" in x for x in seen):
            seen.append(lines.get(timeout=WAIT_S))
        assert seen[0].startswith("[serve] warming 2 bucket shapes")
        url = seen[-1].split("listening on ")[1].split()[0]
        body = json.dumps({"rows": [{"item_id": 3, "item_seq": [1, 2]}, {"item_id": 4}]})
        req = urllib.request.Request(f"{url}/v1/score", data=body.encode())
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            probs = json.loads(resp.read())["probs"]
        assert len(probs) == 2 and all(0 < p < 1 for p in probs)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=WAIT_S) == 0
        reader.join(timeout=WAIT_S)
        tail = []
        while not lines.empty():
            tail.append(lines.get())
        assert "'requests_served': 1" in "".join(tail)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)
