"""The port is complete: every public top-level name of the JAX package has a
same-named top-level counterpart in the same module of the port, apart from
the replacements in ``REPLACED``. Both trees are read by AST; neither
package's modules are imported.

A public name is a top-level ``def``, ``class`` or assigned constant not
starting with ``_`` (at module level, or inside a module-level ``if``,
``try`` or ``with``). A counterpart is any top-level binding of the name in
the port's module, an import included: the port's ``inference/pipeline.py``
takes ``write_csv_chunk`` from its ``submission.py``, as callers may find
it there.

Also: every Pallas file of the JAX package (one that calls
``pl.pallas_call``) is named by a ``"replaces"`` entry of ``chip_smoke.py``'s
kernels line, at a line that defines a kernel function; and the checker
reports a name missing from a tree written here."""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "ctr_recommendation_tpu"
PORT_ROOT = REPO / "ctr_recommendation_tpu_torch"

# JAX module, or module::name -> (the port's counterpart, why it is not the same name)
REPLACED = {
    "ops/pallas/__init__.py": (
        "ops/cuda/__init__.py",
        "the Pallas kernels' package; the port's kernels are hand-written CUDA in csrc/"),
    "ops/pallas/interaction.py": (
        "ops/cuda/interaction.py + csrc/interaction.cu + csrc/interaction_bwd.cu",
        "the SENet + bilinear kernels, forward and backward, as CUDA kernels"),
    "ops/pallas/scoring.py": (
        "ops/cuda/scoring.py + csrc/scoring.cu",
        "the fused scoring kernel as a CUDA kernel"),
    "ops/pallas/sasrec_encoder.py": (
        "ops/cuda/sasrec_encoder.py + csrc/sasrec_encoder.cu + csrc/sasrec_encoder_bwd.cu",
        "the SASRec encoder kernels, forward and backward, as CUDA kernels"),
    "utils/compilation_cache.py": (
        "ops/cuda/build.py",
        "XLA's persistent compile cache; the port caches its nvcc builds by source hash"),
    "inference/predictor.py::build_scan_scorer": (
        "inference/predictor.py::Predictor.score_batches",
        "a lax.scan over stacked batches; the port loops the batches on the device"),
    "data/native/__init__.py::available": (
        "data/parquet.py::pad_from_offsets",
        "reports whether the C++ padding built; the port pads in numpy, no build to report"),
    "data/native/__init__.py::pad_sequences_from_offsets": (
        "data/parquet.py::pad_from_offsets",
        "the C++ history padding; held against it in tests/test_torch_native.py"),
}


def _nested(body):
    """Statements at module level, descending into if / try / with blocks."""
    for node in body:
        yield node
        if isinstance(node, (ast.If, ast.With)):
            yield from _nested(node.body)
            yield from _nested(getattr(node, "orelse", []))
        elif isinstance(node, ast.Try):
            for part in (node.body, node.orelse, node.finalbody):
                yield from _nested(part)
            for handler in node.handlers:
                yield from _nested(handler.body)


def _targets(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)]


def defined_names(path: Path) -> set[str]:
    """Public top-level defs, classes and assigned constants of a module."""
    names = set()
    for node in _nested(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names.update(_targets(node))
    return {n for n in names if not n.startswith("_")}


def bound_names(path: Path) -> set[str]:
    """Every top-level binding of a module, imports included."""
    names = set(defined_names(path))
    for node in _nested(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


def missing_names(jax_root: Path, port_root: Path, rel: str) -> list[str]:
    """The public names of ``jax_root/rel`` with no counterpart in
    ``port_root/rel`` (all of them when the port lacks the module)."""
    want = defined_names(jax_root / rel)
    port = port_root / rel
    have = bound_names(port) if port.exists() else set()
    return sorted(want - have)


def _has(rel_and_name: str) -> bool:
    """Whether the port has ``path`` or ``path::name`` (``Class.method`` too)."""
    rel, _, name = rel_and_name.partition("::")
    path = PORT_ROOT / rel
    if not path.exists():
        return False
    if not name:
        return True
    scope = ast.parse(path.read_text()).body
    for part in name.split("."):
        node = next((n for n in scope if getattr(n, "name", None) == part), None)
        if node is None:
            return False
        scope = getattr(node, "body", [])
    return True


JAX_MODULES = sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py"))


def test_the_jax_tree_is_there():
    assert len(JAX_MODULES) > 50
    assert "data/synthetic.py" in JAX_MODULES and "ops/pooling.py" in JAX_MODULES


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    if rel in REPLACED:  # the module as a whole
        counterpart, _ = REPLACED[rel]
        for part in counterpart.split(" + "):
            assert _has(part), f"{rel}: its replacement {part} is missing"
        return
    assert (PORT_ROOT / rel).exists(), f"{rel}: the port has no such module"
    missing = [n for n in missing_names(JAX_ROOT, PORT_ROOT, rel) if f"{rel}::{n}" not in REPLACED]
    assert not missing, f"{rel}: no counterpart in the port for {missing}"


def test_every_replacement_is_current():
    """Each entry names a JAX module or name that exists and that the port
    lacks under the same name, and a counterpart that the port has."""
    for key, (counterpart, reason) in REPLACED.items():
        rel, _, name = key.partition("::")
        assert rel in JAX_MODULES, key
        assert reason
        if name:
            assert name in defined_names(JAX_ROOT / rel), key
            assert name in missing_names(JAX_ROOT, PORT_ROOT, rel), f"{key}: now ported as is"
        else:
            assert not (PORT_ROOT / rel).exists(), f"{key}: now ported as is"
        assert all(_has(part) for part in counterpart.split(" + ")), key


def test_every_pallas_file_is_replaced_in_chip_smoke():
    smoke = (REPO / "chip_smoke.py").read_text()
    replaced = re.findall(r'"replaces": "ctr_recommendation_tpu/([^":]+):(\d+)"', smoke)
    pallas = sorted(
        str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py")
        if "pl.pallas_call" in p.read_text()
    )
    assert pallas == ["ops/pallas/interaction.py", "ops/pallas/sasrec_encoder.py",
                      "ops/pallas/scoring.py"]
    assert sorted({rel for rel, _ in replaced}) == pallas
    for rel, line in replaced:  # each names the line of a kernel function
        text = (JAX_ROOT / rel).read_text().splitlines()[int(line) - 1]
        assert text.startswith("def "), (rel, line, text)


def test_the_checker_reports_a_missing_name(tmp_path):
    jax_tree, port_tree = tmp_path / "jax", tmp_path / "port"
    for root in (jax_tree, port_tree):
        (root / "sub").mkdir(parents=True)
    (jax_tree / "sub" / "m.py").write_text(
        "import os\nLIMIT = 3\n_private = 1\n\n\ndef kept():\n    pass\n\n\n"
        "class Gone:\n    pass\n\n\nif os.name:\n    def branch():\n        pass\n")
    (port_tree / "sub" / "m.py").write_text(
        "from x import branch\nLIMIT = 3\n\n\ndef kept():\n    def Gone():\n        pass\n")
    (jax_tree / "only.py").write_text("def f():\n    pass\n")
    assert missing_names(jax_tree, port_tree, "sub/m.py") == ["Gone"]
    assert missing_names(jax_tree, port_tree, "only.py") == ["f"]
    (port_tree / "sub" / "m.py").write_text("LIMIT = 3\n\n\ndef kept():\n    pass\n\n\n"
                                            "class Gone:\n    pass\n")
    assert missing_names(jax_tree, port_tree, "sub/m.py") == ["branch"]
