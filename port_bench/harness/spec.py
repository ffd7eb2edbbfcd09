"""Finding a cell's pieces by name.

``BENCHMARK.json`` names the cells; each cell names a configuration (its
file is in the entry's ``file``), a traffic mix (``port_bench/traffic/<traffic>.json``,
whose ``kind`` names the driver in ``port_bench/kinds/<kind>.py``) and is
held to ``port_bench/limits/<cell>.json``. Per-layer metrics are readers in
``port_bench/metrics/<metric>.py``. Adding a configuration, a cell or a
metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    limits: dict  # {check name: limit}
    chips: int
    end_to_end: list  # BENCHMARK.json's end-to-end metric entries this cell reports
    per_layer: list  # ... and its per-layer metric entries
    bench_dir: str = BENCH_DIR

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def load_benchmark(root: str) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        return json.load(f)


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, reported_e2e: set | None = None) -> bool:
    """Whether ``cell`` reports ``metric``: listed under its ``workloads``,
    or (no such key) reported wherever the end-to-end metric it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if reported_e2e is None:
        return True
    return metric.get("moves", metric["name"]) in reported_e2e


def cell(root: str, name: str, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of the checkout at ``root``, with every file it
    names read. Raises KeyError for an unknown cell."""
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(entries)})")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf_entry = configs[w["config"]]
    config = _read(os.path.join(root, conf_entry["file"]))
    traffic = _read(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    limits_path = os.path.join(bench_dir, "limits", name + ".json")
    limits = _read(limits_path)["limits"] if os.path.exists(limits_path) else {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, config, traffic, limits, int(w["chips"]), e2e, per_layer, bench_dir)


def _load(bench_dir: str, folder: str, name: str) -> ModuleType:
    """The module ``port_bench/<folder>/<name>.py``."""
    path = os.path.join(bench_dir, folder, name + ".py")
    mod_name = f"port_bench_{folder}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """The reader module ``port_bench/metrics/<name>.py``."""
    return _load(bench_dir, "metrics", name)


def kind_driver(kind: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """The traffic kind's driver ``port_bench/kinds/<kind>.py``."""
    return _load(bench_dir, "kinds", kind)
