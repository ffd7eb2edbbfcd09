"""The port is complete: every public top-level name of the JAX package has a
same-named top-level counterpart in the same module of the port, and every
public member of a public class (method, property, class attribute or
dataclass field) a same-named member of the port's class, apart from the
replacements in ``REPLACED``. Both trees are read by AST; neither package's
modules are imported by those checks.

A public name is a top-level ``def``, ``class`` or assigned constant not
starting with ``_`` (at module level, or inside a module-level ``if``,
``try`` or ``with``). A counterpart is any top-level binding of the name in
the port's module, an import included: the port's ``inference/pipeline.py``
takes ``write_csv_chunk`` from its ``submission.py``, as callers may find
it there.

A class member counts when the port's class (a top-level class of the same
name in the same module, or the class a top-level import there binds)
defines it in its body or in the body of a base class it names.

Also: every Pallas file of the JAX package (one that calls
``pl.pallas_call``) is named by a ``"replaces"`` entry of ``chip_smoke.py``'s
kernels line, at a line that defines a kernel function; the checkers report
a name or a member missing from a tree written here; and the members added
to close the last gaps (``DeviceItemStore.dim``, ``CheckpointManager.wait``
and ``.close``, ``TrainState.create``) do what their JAX counterparts do."""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "ctr_recommendation_tpu"
PORT_ROOT = REPO / "ctr_recommendation_tpu_torch"

# JAX module, module::name or module::Class.member -> (the port's counterpart,
# why it is not the same name)
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
    "utils/profiling.py::StepTimer": (
        "utils/profiling.py::span",
        "a host EMA of step time that nothing called; the port times its stages with spans "
        "on the profiler's clock"),
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


def _classes(path: Path) -> dict[str, ast.ClassDef]:
    """The top-level classes of a module, by name."""
    return {n.name: n for n in _nested(ast.parse(path.read_text()).body)
            if isinstance(n, ast.ClassDef)}


def _members(node: ast.ClassDef) -> set[str]:
    """The names a class body binds: methods, properties, nested classes,
    class attributes and dataclass fields."""
    names = set()
    for n in node.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            names.update(_targets(n))
    return names


def _port_class(port_root: Path, rel: str, name: str) -> tuple[ast.ClassDef, Path] | None:
    """The port's class ``name`` of module ``rel``: defined there, or bound
    there by ``from <port package>.x.y import name``."""
    path = port_root / rel
    if not path.exists():
        return None
    classes = _classes(path)
    if name in classes:
        return classes[name], path
    pkg = port_root.name
    for node in _nested(ast.parse(path.read_text()).body):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(pkg + "."):
            for a in node.names:
                if (a.asname or a.name) == name:
                    src = node.module[len(pkg) + 1:].replace(".", "/")
                    for cand in (f"{src}.py", f"{src}/__init__.py"):
                        found = _port_class(port_root, cand, a.name)
                        if found:
                            return found
    return None


def port_members(port_root: Path, rel: str, name: str) -> set[str] | None:
    """Every member of the port's class ``name`` in ``rel``, those of the
    bases it names in its own module included (None without the class)."""
    found = _port_class(port_root, rel, name)
    if found is None:
        return None
    node, path = found
    classes, names, todo = _classes(path), set(), [node]
    while todo:
        cls = todo.pop()
        names |= _members(cls)
        todo += [classes[b.id] for b in cls.bases if isinstance(b, ast.Name) and b.id in classes]
    return names


def missing_members(jax_root: Path, port_root: Path, rel: str) -> list[str]:
    """``Class.member`` for each public member of a public class of
    ``jax_root/rel`` that the port's class lacks (the classes the port lacks
    altogether are the top-level check's)."""
    missing = []
    for name, node in _classes(jax_root / rel).items():
        if name.startswith("_"):
            continue
        have = port_members(port_root, rel, name)
        if have is None:
            continue
        missing += [f"{name}.{m}" for m in _members(node) - have if not m.startswith("_")]
    return sorted(missing)


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


CLASS_MODULES = [rel for rel in JAX_MODULES if rel not in REPLACED
                 and any(not n.startswith("_") for n in _classes(JAX_ROOT / rel))]


def test_the_jax_tree_has_classes():
    assert len(CLASS_MODULES) >= 16
    assert "training/checkpoint.py" in CLASS_MODULES and "inference/predictor.py" in CLASS_MODULES


@pytest.mark.parametrize("rel", CLASS_MODULES)
def test_every_public_class_member_has_a_counterpart(rel):
    missing = [m for m in missing_members(JAX_ROOT, PORT_ROOT, rel)
               if f"{rel}::{m}" not in REPLACED]
    assert not missing, f"{rel}: no counterpart in the port's classes for {missing}"


def test_every_replacement_is_current():
    """Each entry names a JAX module, name or class member that exists and
    that the port lacks under the same name, and a counterpart that the
    port has."""
    for key, (counterpart, reason) in REPLACED.items():
        rel, _, name = key.partition("::")
        assert rel in JAX_MODULES, key
        assert reason
        if "." in name:
            cls, member = name.split(".", 1)
            assert member in _members(_classes(JAX_ROOT / rel)[cls]), key
            assert name in missing_members(JAX_ROOT, PORT_ROOT, rel), f"{key}: now ported as is"
        elif name:
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


def test_the_checker_reports_a_missing_member(tmp_path):
    jax_tree, port_tree = tmp_path / "jax", tmp_path / "port"
    for root in (jax_tree, port_tree / "sub"):
        root.mkdir(parents=True)
    (jax_tree / "m.py").write_text(
        "import dataclasses\n\n\n@dataclasses.dataclass\nclass Store:\n    rows: int\n"
        "    LIMIT = 3\n\n    @property\n    def dim(self):\n        return 1\n\n"
        "    def close(self):\n        pass\n\n    def _private(self):\n        pass\n\n\n"
        "class Gone:\n    def f(self):\n        pass\n\n\nclass Moved:\n    def g(self):\n"
        "        pass\n")
    (port_tree / "sub" / "impl.py").write_text("class Moved:\n    pass\n")
    (port_tree / "m.py").write_text(
        "from port.sub.impl import Moved\n\n\nclass Base:\n    def close(self):\n"
        "        pass\n\n\nclass Store(Base):\n    rows = 0\n    LIMIT = 3\n")
    assert missing_members(jax_tree, port_tree, "m.py") == ["Moved.g", "Store.dim"]
    (port_tree / "sub" / "impl.py").write_text("class Moved:\n    def g(self):\n        pass\n")
    (port_tree / "m.py").write_text(
        "from port.sub.impl import Moved\n\n\nclass Store:\n    rows = 0\n    LIMIT = 3\n"
        "    dim = property(lambda self: 1)\n")
    assert missing_members(jax_tree, port_tree, "m.py") == ["Store.close"]


# ------------------------------------------------- the members that closed the gaps

def test_device_item_store_dim():
    """DeviceItemStore.dim: the width of an item's vector, as JAX's."""
    import numpy as np

    from ctr_recommendation_tpu_torch.data import ItemStore
    from ctr_recommendation_tpu_torch.data.device_store import DeviceItemStore

    emb = np.random.default_rng(0).standard_normal((5, 24)).astype(np.float32)
    store = DeviceItemStore.from_host(ItemStore.from_arrays(np.arange(1, 6), emb), "cpu")
    assert store.dim == 24 == store.emb.shape[1]


def test_checkpoint_manager_wait_and_close(tmp_path):
    """Saves are synchronous: wait returns at once with the resume point on
    disk, and close releases nothing, the manager still reading after it."""
    import torch

    from ctr_recommendation_tpu_torch.training.checkpoint import CheckpointManager
    from ctr_recommendation_tpu_torch.training.train_state import TrainState

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state = TrainState(3, {"w": torch.ones(2)}, {}, {"count": 3})
    mgr.save(1, state)
    assert mgr.wait() is None and mgr.latest_step() == 1
    assert mgr.close() is None
    assert mgr.restore()["step"] == 3 and torch.equal(mgr.restore()["params"]["w"], torch.ones(2))


@pytest.mark.parametrize("kind", ["adam", "adagrad"])
def test_train_state_create(kind):
    """TrainState.create: step 0, tx.init over the leaves of params in the
    trainer's (tree_leaves) order, table_opt_state {} unless given; the
    state takes an update."""
    import torch

    from ctr_recommendation_tpu_torch.training.optim import Optimizer
    from ctr_recommendation_tpu_torch.training.train_state import TrainState
    from ctr_recommendation_tpu_torch.utils.tree import tree_leaves

    params = {"b": [torch.ones(3), torch.full((2, 2), 2.0)], "a": {"w": torch.zeros(4)}}
    tx = Optimizer(kind, lambda count: 0.1, clip_norm=0.0, weight_decay=0.0)
    st = TrainState.create(params, {"bn": 1}, tx)
    assert (st.step, st.params, st.model_state, st.table_opt_state) == (0, params, {"bn": 1}, {})
    slots = ("mu", "nu") if kind == "adam" else ("sum_of_squares",)
    assert sorted(st.opt_state) == sorted(("count",) + slots) and st.opt_state["count"] == 0
    for slot in slots:
        assert [t.shape for t in st.opt_state[slot]] == [t.shape for t in tree_leaves(params)]
        assert all(not t.any() for t in st.opt_state[slot])
    leaves = tree_leaves(params)
    tx.update([torch.ones_like(t) for t in leaves], st.opt_state, leaves)
    assert st.opt_state["count"] == 1 and not torch.equal(params["b"][0], torch.ones(3))
    table = {"item_id": {"sum_of_squares": torch.zeros(3)}}
    assert TrainState.create(params, {}, tx, table_opt_state=table).table_opt_state == table
