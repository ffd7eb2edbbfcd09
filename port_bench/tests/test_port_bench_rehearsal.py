"""Each cell rehearsed on the CPU at a tiny size through the port's plain
paths (the kernels' plain versions): a whole run but the look for a chip,
its result line, the plain reference against the port in float32 (where
the two compute the same function to round-off), the control failing the
limits the program passes, and each planted fault the cell can have
turning ``correct`` false."""

import dataclasses
import json
import math
import time

import pytest
import torch

from conftest import ROOT
from harness import runner, spec

# rows and batches small enough for the CPU; every width as the cell has it
SHRINK = {
    "mm_fibinet.train_b131072": {"batch_size": 8192, "train_rows": 32768},
    "sasrec_fibinet_ml1m.train_b4096": {"batch_size": 8, "train_rows": 64},
    "sasrec_fibinet_ml1m.score_b8192": {"batch_size": 24, "test_rows": 60},
}
CELLS = list(SHRINK)
TRAIN = [c for c in CELLS if ".train_" in c]
SCORE = [c for c in CELLS if ".score_" in c]
SEED = 2**33 + 12345  # past 32 bits, as the driver's seeds are


def run(name, *, trace=False, cell=None, seed=SEED):
    cell = cell or spec.cell(ROOT, name)
    return runner.run_cell(cell, seed=seed, seconds=0.05, trace=trace, device="cpu",
                           stages=[("start", time.perf_counter())], shrink=SHRINK[name])


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal(name):
    result, lines = run(name)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    cell = spec.cell(ROOT, name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for k, m in result["metrics"].items() if k != "peak_mem_gib")
    assert result["device"]["platform"] == "cpu"  # never a device metric's name for it
    assert set(result["checks"]) == set(cell.limits)
    assert result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    json.dumps(result)


def test_rehearsal_traced():
    name = "sasrec_fibinet_ml1m.score_b8192"
    result, _ = run(name, trace=True)
    assert list(result)[-2:] == ["breakdown", "checks"]
    cell = spec.cell(ROOT, name)
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _in_float32(cell):
    cfg = json.loads(json.dumps(cell.config))
    cfg["overrides"]["compute_dtype"] = "float32"
    cfg["sizes"]["compute_dtype"] = "float32"
    return dataclasses.replace(cell, config=cfg)


@pytest.mark.parametrize("name", CELLS)
def test_reference_is_the_port_in_float32(name):
    """In float32 the port and the plain reference compute one function: the
    gaps are round-off, orders below the limits set for bf16."""
    from calibrate import calibrate

    cell = _in_float32(spec.cell(ROOT, name))
    got = calibrate(cell, SEED, "cpu", control=False, shrink=SHRINK[name])["program"]
    tight = {"loss_gap": 1e-5, "prob_gap": 1e-5}
    for k, v in got.items():
        assert v <= tight.get(k, 1e-4), (k, v)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    """The control (the reference in scaled fp8 where the configuration
    computes in bf16) fails the cell's limits, and so does a training step
    that leaves half of its batch out of the loss. (That the port passes
    them at the cell's own size is the chip's to show: at these few rows a
    bf16 gradient is noisier than at the cell's batch.)"""
    from calibrate import calibrate

    cell = spec.cell(ROOT, name)
    got = calibrate(cell, SEED + 1, "cpu", control=True, shrink=SHRINK[name])

    def fails(readings):
        return any(not math.isfinite(readings[k]) or readings[k] > lim
                   for k, lim in cell.limits.items())

    assert fails(got["control"]), got
    if "half_batch" in got:
        assert fails(got["half_batch"]), got


def _unchanged_state(monkeypatch):
    from ctr_recommendation_tpu_torch.training import loop

    def apply_gradients(self, grads, aux):
        self.state.model_state = aux.model_state
        self.state.step += 1

    monkeypatch.setattr(loop.Trainer, "apply_gradients", apply_gradients)


def _half_batch(monkeypatch):
    from ctr_recommendation_tpu_torch.training import loop

    orig = loop.bce_with_logits

    def half(logits, labels, weight=None, data=None):
        n = logits.shape[0] // 2
        return orig(logits[:n], labels[:n], None if weight is None else weight[:n], data)

    monkeypatch.setattr(loop, "bce_with_logits", half)


def _half_rows_unscored(monkeypatch):
    from ctr_recommendation_tpu_torch.inference.predictor import Predictor

    orig = Predictor._score

    def score(self, feats):
        out = orig(self, feats).clone()
        out[out.shape[0] // 2:] = 0.0
        return out

    monkeypatch.setattr(Predictor, "_score", score)


def _answer_altered(monkeypatch):
    from ctr_recommendation_tpu_torch.inference.predictor import Predictor

    orig = Predictor._score

    def score(self, feats):
        out = orig(self, feats).clone()
        out[0] = 1.0 - out[0]
        return out

    monkeypatch.setattr(Predictor, "_score", score)


FAULTS = ([(c, f) for c in TRAIN for f in (_unchanged_state, _half_batch)]
          + [(c, f) for c in SCORE for f in (_half_rows_unscored, _answer_altered)])


@pytest.mark.parametrize("name,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_planted_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result, lines = run(name)
    assert result["correct"] is False, lines


def test_seeds_make_the_inputs():
    """The same seed gives the same inputs and weights; another seed others."""
    from harness import data, seeds, weights

    cell = spec.cell(ROOT, "mm_fibinet.train_b131072")
    sizes = cell.config["sizes"]

    def make(seed):
        g = torch.Generator().manual_seed(seeds.sub_seed(seed, "data"))
        world = data.World(g, sizes, "cpu")
        cols = data.rows(g, world, 300, sizes, [0, 20], label=True, device="cpu")
        p, _ = weights.make(sizes, torch.Generator().manual_seed(seeds.sub_seed(seed, "w")), "cpu")
        return cols, p["bilinear"]["w"]

    a, b, c = make(SEED), make(SEED), make(SEED + 1)
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0]["item_seq"], c[0]["item_seq"])
    lens = (a[0]["item_seq"] != 0).sum(1)
    assert int(lens.min()) >= 0 and int(lens.max()) <= 20
    # left-padded: every pad step comes before the history's first item
    first = (a[0]["item_seq"] != 0).int().argmax(1)
    assert bool(((a[0]["item_seq"] != 0).sum(1) == 0).logical_or(
        first == 20 - lens).all())
