"""The JAX guard compares whole top-level names; the reference imports
nothing of the port or of JAX; a run holding a forbidden module prints no
result and exits non-zero; the harness, the port and the reference load no
forbidden module."""

import ast
import json
import os
import subprocess
import sys

from conftest import BENCH, ROOT
from harness import guard, runner

PORT = "ctr_recommendation_tpu_torch"


def test_whole_top_level_names():
    mods = {"ctr_recommendation_tpu_torch": 1, "ctr_recommendation_tpu_torch.models": 1,
            "jaxtyping": 1, "numpy": 1}
    assert guard.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "ctr_recommendation_tpu.models": 1, "flax": 1, "jaxlib": 1})
    assert guard.forbidden_modules(mods) == ["ctr_recommendation_tpu.models", "flax", "jax.numpy",
                                             "jaxlib"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_reference_imports_neither_the_port_nor_jax():
    ref = os.path.join(BENCH, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, name))}
            assert tops <= {"__future__", "math", "typing", "torch", "reference"}, (name, tops)


def test_only_program_imports_the_port():
    for d in ("harness", "kinds", "metrics", "reference"):
        for name in os.listdir(os.path.join(BENCH, d)):
            if name.endswith(".py") and name != "program.py":
                tops = {m.split(".")[0] for m in _imports(os.path.join(BENCH, d, name))}
                assert PORT not in tops and not tops & guard.FORBIDDEN, (d, name, tops)


def test_emit_refuses_with_a_forbidden_module(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    assert runner.emit({"correct": True}, ["check x: 0 (limit 1) ok"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_emit_prints_checks_last_and_strict_json(capsys):
    assert runner.emit({"correct": False, "checks": {"x": {"value": float("inf"),
                                                           "limit": 1.0}}},
                       ["check x: inf (limit 1.0) FAIL"]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1])["checks"]["x"]["value"] is None
    assert out.err.strip().splitlines()[-1].startswith("check x")


def test_the_benchmark_loads_no_forbidden_module():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from harness import program, runner, spec, guard\n"
            "spec.kind_driver('train'); spec.kind_driver('score')\n"
            "import calibrate\n"
            "from reference import model, train, precision\n"
            "print(guard.forbidden_modules())" % (BENCH, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_device():
    """No CUDA device here: the run exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "sasrec_fibinet_ml1m.score_b8192", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_without_the_port(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "sasrec_fibinet_ml1m.score_b8192", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
