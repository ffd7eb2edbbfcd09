"""The port's table gradient (``ops/cuda/table_grad.py``) and its three call
sites against the JAX package on the CPU.

The kernel (csrc/table_grad.cu) runs on the card only; ``chip_smoke.py``
holds it against the fp64 plain version there and its repeats bit for bit.
Here a CPU tensor takes ``table_grad_plain`` (fp32 ``index_add_`` in the ids'
order), and seeded numpy inputs go through it and the JAX function:

* ``table_grad_plain`` against ``jnp.zeros(...).at[ids].add(cot)`` at rtol 0
  and atol 1e-6: 8192 ids of 10 values into 129 rows (the shared
  likes_level table's step), a 40-row table with pad-heavy ids, E = 10, ids
  in the cut-off row;
* the call sites' gradients at rtol 0 and atol 1e-6: the trunk's ``gather``
  and ``sparse.multi_feature_lookup`` against JAX's
  ``multi_feature_lookup``; the gathered strategy's row-buffer lookup
  (``Trainer._merged_lookup``) against JAX's gather of the same rows; the
  row-sharded lookup's backward at 1 x 2 over gloo (one spawn of
  ``tests/_torch_dp_worker.py``) against the one-process scatter-add;
* one ``table_grad`` a table a step (what ``chip_smoke.py``'s exact launch
  counts assume), for both models with dense tables, each sparse strategy
  and the nine zoo models, seen through a spy;
* no module of the port reaches ``embedding_dense_backward`` or
  differentiates through ``F.embedding``; ``fits`` and the wrapper's
  refusals.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ZOO
from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.training import sparse as jax_sparse
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.models import trunk
from ctr_recommendation_tpu_torch.ops.cuda import table_grad as tg
from ctr_recommendation_tpu_torch.training import Trainer
from ctr_recommendation_tpu_torch.training import sparse
from tests import _torch_dp_worker as worker
from tests.conftest import make_batch

torch.set_num_threads(2)

PORT = Path(__file__).resolve().parents[1] / "ctr_recommendation_tpu_torch"


def _jax_grad(ids, cot, rows):
    return np.asarray(jnp.zeros((rows, cot.shape[1]), jnp.float32)
                      .at[jnp.asarray(ids)].add(jnp.asarray(cot)))


def _pad_heavy(rng, n, rows):
    ids = rng.integers(1, rows, n)
    ids[rng.random(n) < 0.7] = 0
    return ids


# ------------------------------------------------------------ the function
@pytest.mark.parametrize("case", ["likes_level", "pad_heavy", "e10", "cut_off_row"])
def test_plain_matches_jax_scatter_add(case):
    rng = np.random.default_rng(3)
    n, rows, e = {"likes_level": (8192, 129, 128), "pad_heavy": (2000, 40, 16),
                  "e10": (1500, 41, 10), "cut_off_row": (600, 33, 8)}[case]
    ids = {"likes_level": lambda: rng.integers(0, 10, n),
           "pad_heavy": lambda: _pad_heavy(rng, n, rows),
           "e10": lambda: rng.integers(0, rows, n),
           # the trunk's extra row: ids out of range land in row rows - 1
           "cut_off_row": lambda: np.where(rng.random(n) < 0.3, rows - 1,
                                           rng.integers(0, rows - 1, n))}[case]()
    cot = rng.standard_normal((n, e)).astype(np.float32)
    got = tg.table_grad(torch.from_numpy(ids), torch.from_numpy(cot), rows)
    np.testing.assert_allclose(got.numpy(), _jax_grad(ids, cot, rows), rtol=0, atol=1e-6)
    assert got.dtype == torch.float32 and got.shape == (rows, e)
    assert torch.equal(got, tg.table_grad_plain(torch.from_numpy(ids), torch.from_numpy(cot),
                                                rows))
    if case == "cut_off_row":
        assert got[-1].abs().sum() > 0


# ------------------------------------------------------------ the call sites
@pytest.mark.parametrize("via", ["gather", "multi_feature_lookup"])
def test_trunk_lookups_match_jax_multi_feature_lookup(via):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((129, 16)).astype(np.float32)
    ids = [rng.integers(-129, 140, (64,)).astype(np.int32),
           _pad_heavy(rng, (8, 64), 129).astype(np.int32)]
    cots = [rng.standard_normal((*i.shape, 16)).astype(np.float32) for i in ids]

    def jax_loss(t):
        outs = jax_sparse.multi_feature_lookup(t, *[jnp.asarray(i) for i in ids])
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    tids = [torch.from_numpy(i) for i in ids]
    outs = ([trunk.gather(t, i) for i in tids] if via == "gather"
            else sparse.multi_feature_lookup(t, *tids))
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    (g,) = torch.autograd.grad(loss, [t])
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-6)


def test_gathered_row_buffer_lookup_matches_jax_gather():
    """The gathered strategy: planned features read their share of the row
    buffer's merged lookup, another feature of the table ``gather``s it."""
    rng = np.random.default_rng(6)
    buf = rng.standard_normal((50, 12)).astype(np.float32)  # the step's unique rows
    ids = {"item_id": rng.integers(0, 50, (32,)), "item_seq": _pad_heavy(rng, (32, 6), 50),
           "other": rng.integers(0, 50, (32,))}
    cots = {k: rng.standard_normal((*v.shape, 12)).astype(np.float32) for k, v in ids.items()}

    def jax_loss(r):
        return sum(jnp.sum(r[jnp.asarray(v)] * cots[k]) for k, v in ids.items())

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(buf)))
    rows = torch.from_numpy(buf).requires_grad_()
    tids = {k: torch.from_numpy(v) for k, v in ids.items()}
    multi = {"item_id": [("item_id", tids["item_id"]), ("item_seq", tids["item_seq"])]}
    lookup = Trainer._merged_lookup({}, {"item_id": rows}, multi)
    loss = sum((lookup({}, "item_id", v, feature=k) * torch.from_numpy(cots[k])).sum()
               for k, v in tids.items())
    (g,) = torch.autograd.grad(loss, [rows])
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Each model rank's outputs of the lookup scenarios at 1 x 2."""
    path = str(tmp_path_factory.mktemp("table_grad") / "1x2")
    worker.run_ranks([{"kind": "lookup", "name": "lookup", "mp": 2}], path, world=2)
    return [worker.load(path, "lookup", r) for r in range(2)]


@pytest.mark.parametrize("name", [sc["name"] for sc in worker.lookup_scenarios()])
def test_sharded_lookup_backward_matches_one_process(sharded, name):
    """The row-sharded lookup's local backward, the two owners' shards put
    together, against the one-process scatter-add of the same cotangents
    (JAX's and the port's plain one): no gradient for ids out of range or
    for excluded pad ids."""
    sc = next(s for s in worker.lookup_scenarios() if s["name"] == name)
    table, ids = sc["table"], sc["ids"].reshape(-1)
    keep = (ids >= 0) & (ids < len(table))
    if sc["pad"] is not None:
        keep &= ids != sc["pad"]
    rows = table[ids[keep]]
    cot = np.full_like(rows, 2.0) if sc["loss"] == "x2" else 2.0 * rows
    got = np.concatenate([r[f"{name}/grad"] for r in sharded])
    want = _jax_grad(ids[keep], cot, len(table))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    plain = tg.table_grad_plain(torch.from_numpy(ids[keep]), torch.from_numpy(cot), len(table))
    np.testing.assert_allclose(got, plain.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("model,strategy", [("mm_fibinet", "dense"), ("sasrec_fibinet", "dense"),
                                            ("mm_fibinet", "masked_dense"),
                                            ("mm_fibinet", "gathered"),
                                            *((m, "dense") for m in ZOO)])
def test_one_table_grad_a_table_a_step(tiny_experiment, tmp_path, monkeypatch, model, strategy):
    """A step calls table_grad once for each of the two tables it looks up
    (item_id: item_id + item_seq; likes_level: likes_level + views_level),
    whatever the strategy and the model: the count chip_smoke.py's launch
    checks hold (TG_TABLES)."""
    calls = []

    def spy(ids, cot, rows):
        calls.append((ids.numel(), rows))
        return tg.table_grad(ids, cot, rows)

    monkeypatch.setattr(trunk, "table_grad", spy)
    monkeypatch.setattr(sparse, "GATHERED_MIN_VOCAB_RATIO",
                        {"gathered": 0.0, "masked_dense": 1e12}.get(strategy, 4.0))
    table_opt = "dense" if strategy == "dense" else "rowwise_adagrad"
    exp = tiny_experiment.replace(
        model=dataclasses.replace(tiny_experiment.model, model=model),
        train=dataclasses.replace(tiny_experiment.train, table_optimizer=table_opt,
                                  checkpoint_dir=str(tmp_path), tensorboard=False))
    tr = Trainer(pt_serialize.from_json(jax_serialize.to_json(exp)), total_steps=4,
                 device="cpu", log_fn=lambda s: None)
    rng = np.random.default_rng(8)
    batch = make_batch(rng, 64)
    batch["label"] = (rng.random(64) < 0.5).astype(np.float32)
    for _ in range(2):
        calls.clear()
        tr.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
        # item ids: 64 targets + 64 x 8 history; likes: 2 x 64 (+ 1 extra row each)
        assert sorted(n for n, _ in calls) == [128, 576], calls


# ------------------------------------------------------------ the envelope
def test_no_module_reaches_the_library_backward():
    """No module of the port names embedding_dense_backward, calls
    F.embedding or builds an nn.Embedding: every table gradient is
    table_grad's."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        src = path.read_text()
        if "embedding_dense_backward" in src:
            found.append(f"{path.name}: embedding_dense_backward")
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Attribute) and node.attr in ("embedding", "Embedding") \
                    and isinstance(node.value, (ast.Name, ast.Attribute)) \
                    and ast.unparse(node.value) in ("F", "functional", "torch.nn.functional",
                                                    "nn", "torch.nn"):
                found.append(f"{path.name}:{node.lineno}: {ast.unparse(node)}")
    assert not found, found


@pytest.mark.parametrize("shape,ok", [
    ((86016, 91777, 128), True), ((0, 1, 1), True), ((tg.MAX_IDS, tg.MAX_ROWS, 10), True),
    ((-1, 10, 8), False), ((tg.MAX_IDS + 1, 10, 8), False), ((10, 0, 8), False),
    ((10, tg.MAX_ROWS + 1, 8), False), ((10, 10, 0), False)])
def test_fits(shape, ok):
    assert tg.fits(*shape) is ok
    if ok:
        tg.check_envelope(*shape)
    else:
        with pytest.raises(ValueError, match="table_grad needs"):
            tg.check_envelope(*shape)


def test_the_wrapper_takes_only_cpu_or_cuda_tensors():
    ids = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tg.table_grad(ids, torch.zeros(4, 3, device="meta"), 5)
    assert tg.launches() == 2 and tg.table_grad.launches == 0  # never on the CPU
