"""The harness finds every cell, configuration, traffic mix, limits file and
per-layer metric by its name in BENCHMARK.json, and BENCHMARK.json keeps
the contract's shape; a cell and a metric added as files alone are taken."""

import json
import os
import re
import shutil

import pytest

from conftest import BENCH, ROOT
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["port_bench"] and b["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert len(json.dumps(b)) <= 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in b[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)


def test_metric_entries():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["better"] in ("lower", "higher") and "\n" not in m["layer"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
def test_cell_found_by_name(name):
    cell = spec.cell(ROOT, name)
    assert cell.kind in ("train", "score")
    assert spec.kind_driver(cell.kind).Job
    assert cell.limits, "every cell has a limits file"
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
        reader = spec.metric_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"], m["moves"])
    w = next(x for x in bench()["workloads"] if x["name"] == name)
    assert len(w["why"]) <= 200 and w["chips"] == 1
    hist = cell.traffic["hist_len"]
    assert 0 <= hist[0] <= hist[1] <= cell.config["sizes"]["max_len"]


@pytest.mark.parametrize("entry", bench()["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    path = os.path.join(ROOT, entry["file"])
    assert entry["file"].startswith("port_bench/")
    cfg = json.load(open(path))
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert os.path.exists(os.path.join(BENCH, "reference", "model.py"))


def test_the_port_resolves_each_configuration_as_stated():
    from harness import program

    for entry in bench()["configs"]:
        cfg = json.load(open(os.path.join(ROOT, entry["file"])))
        program.experiment(cfg, batch_size=4096)  # raises where a size moved


def test_a_cell_and_a_metric_added_as_files_alone(tmp_path):
    """A later PR's cell and per-layer metric: new files and new entries in
    BENCHMARK.json, no file of the harness edited."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    b["workloads"].append({"name": "mm_fibinet.score_dummy", "config": "mm_fibinet",
                           "traffic": "score_dummy", "chips": 1, "why": "a test's cell"})
    b["per_layer"].append({"name": "dummy.rows_per_call", "unit": "rows/call", "better": "higher",
                           "source": "host_clock", "layer": "Predictor (inference/predictor.py)",
                           "moves": "score_rows_per_s", "workloads": ["mm_fibinet.score_dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    pb = root / "port_bench"
    (pb / "traffic" / "score_dummy.json").write_text(json.dumps(
        {"kind": "score", "batch_size": 64, "test_rows": 100, "hist_len": [0, 20]}))
    (pb / "limits" / "mm_fibinet.score_dummy.json").write_text(
        json.dumps({"limits": {"prob_gap": 0.5}}))
    (pb / "metrics" / "dummy.rows_per_call.py").write_text(
        'UNIT = "rows/call"\nLAYER = "Predictor (inference/predictor.py)"\n'
        'MOVES = "score_rows_per_s"\n\n\ndef read(run):\n'
        '    return run.stats["rows"] / run.stats["steps"]\n')
    cell = spec.cell(str(root), "mm_fibinet.score_dummy", bench_dir=str(pb))
    assert cell.traffic["test_rows"] == 100 and cell.limits == {"prob_gap": 0.5}
    assert [m["name"] for m in cell.per_layer if m["name"].startswith("dummy")] == [
        "dummy.rows_per_call"]
    reader = spec.metric_reader("dummy.rows_per_call", bench_dir=str(pb))
    run = type("R", (), {"stats": {"rows": 300, "steps": 3}})()
    assert reader.read(run) == 100
    # the existing cells do not report it
    assert "dummy.rows_per_call" not in {
        m["name"] for m in spec.cell(str(root), "sasrec_fibinet_ml1m.score_b8192",
                                     bench_dir=str(pb)).per_layer}
