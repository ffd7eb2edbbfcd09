"""The metrics read from the port's own spans, rehearsed on the CPU: a traced
run of each cell at a tiny size (the kernels' plain versions) reads every
span metric the cell lists, each from the spans of the window alone; the
stages lie inside the step; the upload's bytes are the split's columns,
once a call."""

import time

import pytest

from conftest import ROOT
from ctr_recommendation_tpu_torch.utils.profiling import RECORDER
from harness import runner, spec

SHRINK = {
    "mm_fibinet.train_b131072": {"batch_size": 8192, "train_rows": 32768},
    "sasrec_fibinet_ml1m.train_b4096": {"batch_size": 8, "train_rows": 64},
    "sasrec_fibinet_ml1m.score_b8192": {"batch_size": 24, "test_rows": 60},
}
SPAN_METRICS = {
    "train": ["trunk.train_ms_per_step", "interaction.train_ms_per_step",
              "tower.train_ms_per_step", "optim.update_ms_per_step",
              "trainer.unspanned_ms_per_step"],
    "score": ["predictor.upload_gb_per_s"],
}
SEED = 2**33 + 4321


def traced(name):
    RECORDER.reset()
    cell = spec.cell(ROOT, name)
    result, lines = runner.run_cell(cell, seed=SEED, seconds=0.05, trace=True, device="cpu",
                                    stages=[("start", time.perf_counter())], shrink=SHRINK[name])
    return cell, result, lines


@pytest.mark.parametrize("name", list(SHRINK))
def test_span_metrics_read_in_a_traced_run(name):
    cell, result, lines = traced(name)
    assert result["correct"], lines
    want = SPAN_METRICS[cell.kind]
    assert set(want) <= {m["name"] for m in cell.per_layer}
    got = result["metrics"]
    for m in want:
        assert m in got and got[m]["value"] is not None, (m, lines)
        assert got[m]["value"] >= 0.0, (m, got[m])
    tot = RECORDER.totals()
    if cell.kind == "train":
        for m in want[:-1]:
            assert got[m]["value"] > 0.0, m
        steps = tot["train.step"]["calls"]
        assert steps == result["attempted"]  # the window's steps alone, not the warm-up's
        stages = sum(v["device_s"] for k, v in tot.items() if k in (
            "train.join", "trunk", "trunk.bwd", "interaction", "interaction.bwd", "tower",
            "train.loss", "tower.bwd", "train.optimizer"))
        assert stages <= tot["train.step"]["device_s"]
        assert any(line.startswith("trainer.unspanned_ms_per_step: train.step") for line in lines)
    else:
        calls = result["attempted"]
        assert tot["score.upload"]["calls"] == calls
        rows, bs = SHRINK[name]["test_rows"], SHRINK[name]["batch_size"]
        assert tot["score.batch"]["calls"] == calls * -(-rows // bs)
        assert got["predictor.upload_gb_per_s"]["value"] > 0.0


def test_untraced_run_records_no_span():
    name = "sasrec_fibinet_ml1m.score_b8192"
    RECORDER.reset()
    result, lines = runner.run_cell(spec.cell(ROOT, name), seed=SEED, seconds=0.05, trace=False,
                                    device="cpu", stages=[("start", time.perf_counter())],
                                    shrink=SHRINK[name])
    assert result["correct"], lines
    assert RECORDER.totals() == {}
    assert not set(SPAN_METRICS["score"]) & set(result["metrics"])
