"""The port's table gradient (``ops/cuda/table_grad.py``) and its three call
sites against the JAX package on the CPU.

The kernel (csrc/table_grad.cu) runs on the card only; ``chip_smoke.py``
holds it against the fp64 plain version there, bit for bit against
``table_grad_order`` (its order in PyTorch) and its repeats bit for bit.
Here a CPU tensor takes ``table_grad_plain`` (fp32 ``index_add_`` in the
positions' order), and seeded numpy inputs go through it and the JAX
function:

* ``table_grad_plain`` against ``jnp.zeros(...).at[ids].add(cot)`` at rtol 0
  and atol 1e-6: 8192 ids of 10 values into 129 rows (the shared
  likes_level table's step), a 40-row table with pad-heavy ids, E = 10, ids
  in the cut-off row; ids out of range adding nothing;
* ``table_grad_order`` (both paths: runs inside a warp's sub-chunk, across
  sub-chunks, across 2 chunks and across hundreds, untouched rows, the
  cut-off row, E = 10, each side of the shared path's edge, 256 slices, no
  ids) against JAX's scatter-add at atol 1e-6 and the fp64 plain version
  within ``chip_smoke.TG_NORM_TOL``;
* ``plan`` and ``launches(n, rows, e)`` against hand-counted launches and
  scratch, and ``chip_smoke.tg_step_launches`` (the launch arithmetic of its
  exact checks) on the MicroLens step shapes;
* a call on 1 to ``MAX_SEGMENTS`` segments (one a transposed history
  cotangent) bit for bit the call on their concatenation, and the strided
  grid through which the kernel reads a segment in place;
* the call sites' gradients at rtol 0 and atol 1e-6: the trunk's ``gather``
  and ``sparse.multi_feature_lookup`` (also past ``MAX_SEGMENTS``
  features) against JAX's ``multi_feature_lookup``; the gathered strategy's
  row-buffer lookup (``Trainer._merged_lookup``) against JAX's gather of
  the same rows; the row-sharded lookup's backward at 1 x 2 over gloo (one
  spawn of ``tests/_torch_dp_worker.py``) against the one-process
  scatter-add;
* one ``table_grad`` a table a step on one segment a feature (no call site
  concatenates cotangents), its shapes ``chip_smoke.tg_step_shapes``', for
  both models with dense tables, each sparse strategy and the nine zoo
  models, seen through a spy;
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

import chip_smoke
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
    got = tg.table_grad([(torch.from_numpy(ids), torch.from_numpy(cot))], rows)
    np.testing.assert_allclose(got.numpy(), _jax_grad(ids, cot, rows), rtol=0, atol=1e-6)
    assert got.dtype == torch.float32 and got.shape == (rows, e)
    assert torch.equal(got, tg.table_grad_plain([(torch.from_numpy(ids), torch.from_numpy(cot))],
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
    plain = tg.table_grad_plain([(torch.from_numpy(ids[keep]), torch.from_numpy(cot))],
                                len(table))
    np.testing.assert_allclose(got, plain.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("model,strategy", [("mm_fibinet", "dense"), ("sasrec_fibinet", "dense"),
                                            ("mm_fibinet", "masked_dense"),
                                            ("mm_fibinet", "gathered"),
                                            *((m, "dense") for m in ZOO)])
def test_one_table_grad_a_table_a_step(tiny_experiment, tmp_path, monkeypatch, model, strategy):
    """A step calls table_grad once for each of the two tables it looks up
    (item_id: item_id + item_seq; likes_level: likes_level + views_level),
    whatever the strategy and the model, on one segment a feature: no call
    site concatenates the cotangents. The calls' shapes are
    chip_smoke.tg_step_shapes' and their launches(n, rows, E) sum to
    chip_smoke.tg_step_launches: the arithmetic of chip_smoke.py's exact
    launch checks."""
    calls = []

    def spy(segments, rows):
        segs = list(segments)
        calls.append(([i.numel() for i, _ in segs], rows, segs[0][1].shape[-1]))
        for ids, cot in segs:
            assert tuple(cot.shape[:-1]) == tuple(ids.shape), (ids.shape, cot.shape)
        return tg.table_grad(segs, rows)

    monkeypatch.setattr(trunk, "table_grad", spy)
    monkeypatch.setattr(sparse, "GATHERED_MIN_VOCAB_RATIO",
                        {"gathered": 0.0, "masked_dense": 1e12}.get(strategy, 4.0))
    table_opt = "dense" if strategy == "dense" else "rowwise_adagrad"
    exp = tiny_experiment.replace(
        model=dataclasses.replace(tiny_experiment.model, model=model),
        train=dataclasses.replace(tiny_experiment.train, table_optimizer=table_opt,
                                  checkpoint_dir=str(tmp_path), tensorboard=False))
    pt_exp = pt_serialize.from_json(jax_serialize.to_json(exp))
    tr = Trainer(pt_exp, total_steps=4, device="cpu", log_fn=lambda s: None)
    rng = np.random.default_rng(8)
    batch = make_batch(rng, 64)
    batch["label"] = (rng.random(64) < 0.5).astype(np.float32)
    for _ in range(2):
        calls.clear()
        tr.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
        # item ids: 64 targets + 64 x 8 history; likes: 64 + 64 (+ 1 extra row each)
        assert sorted(sorted(segs) for segs, _, _ in calls) == [[64, 64], [64, 512]], calls
        shapes = sorted((sum(segs), rows, e) for segs, rows, e in calls)
        assert shapes == sorted(chip_smoke.tg_step_shapes(pt_exp, 64)), calls
        assert sum(tg.launches(*sh) for sh in shapes) == chip_smoke.tg_step_launches(pt_exp, 64)


def test_merged_lookup_past_max_segments_matches_jax():
    """One table read by more features than a call takes segments: the last
    ones merged into one, the gradient still JAX's."""
    rng = np.random.default_rng(12)
    table = rng.standard_normal((40, 8)).astype(np.float32)
    ids = [rng.integers(0, 40, (6, 3)).astype(np.int32) for _ in range(tg.MAX_SEGMENTS + 2)]
    cots = [rng.standard_normal((*i.shape, 8)).astype(np.float32) for i in ids]

    def jax_loss(t):
        outs = jax_sparse.multi_feature_lookup(t, *[jnp.asarray(i) for i in ids])
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    outs = sparse.multi_feature_lookup(t, *[torch.from_numpy(i) for i in ids])
    (g,) = torch.autograd.grad(sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)),
                               [t])
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-6)


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
    ((10, tg.MAX_ROWS + 1, 8), False), ((10, 10, 0), False),
    ((10, 10, 8, tg.MAX_SEGMENTS), True), ((10, 10, 8, tg.MAX_SEGMENTS + 1), False),
    ((10, 10, 8, 0), False)])
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
        tg.table_grad([(ids, torch.zeros(4, 3, device="meta"))], 5)
    with pytest.raises(ValueError, match="at least one"):
        tg.table_grad([], 5)
    with pytest.raises(ValueError, match="table_grad: ids"):
        tg.table_grad([(torch.zeros(4, dtype=torch.int64), torch.zeros(5, 3))], 5)
    assert tg.launches(8192, 129, 128) == 2 and tg.table_grad.launches == 0  # never on the CPU


# ------------------------------------------------------------ the plan
# (ids, rows, E) -> (path, launches, blocks, positions a slice, partial
# floats, int32 scratch), counted by hand from csrc/table_grad.cu: shared
# while rows x E x 4 B <= 160 KiB, slices of max(128, ceil(n / 256))
# positions, one launch for one slice else two; sorted, chunks of 256, a
# key sort of 9 bits a pass over keys in [0, rows] (3 launches a pass: 2
# passes up to 2^18 - 1 rows), the chunk and row passes (the row pass alone
# for no ids); its scratch the sort's keys and values twice (4n), 512
# counts a tile of 1024 keys and 512 digit totals, a span (2 ints) a row
PLANS = {
    (8192, 129, 128): ("shared", 2, 64, 128, 64 * 129 * 128, 0),  # likes_level, a step
    (4096, 65, 128): ("shared", 2, 32, 128, 32 * 65 * 128, 0),  # its shard at 1 x 2
    (8192, 129, 256): ("shared", 2, 64, 128, 64 * 129 * 256, 0),  # E = 256: 132 KB
    (128, 320, 128): ("shared", 1, 1, 128, 0, 0),  # 160 KiB exactly: one slice
    (129, 320, 128): ("shared", 2, 2, 128, 2 * 320 * 128, 0),
    (100, 321, 128): ("sorted", 5, 1, 0, 2 * 128, 400 + 512 * 2 + 2 * 321),  # 4 B past the edge
    (86016, 91777, 128): ("sorted", 8, 336, 0, 2 * 336 * 128,  # the item table
                          4 * 86016 + 512 * 85 + 2 * 91777),
    (21504, 21506, 128): ("sorted", 8, 84, 0, 2 * 84 * 128,  # its row buffer
                          4 * 21504 + 512 * 22 + 2 * 21506),
    (81920, 45889, 128): ("sorted", 8, 320, 0, 2 * 320 * 128,  # a shard
                          4 * 81920 + 512 * 81 + 2 * 45889),
    (10, 2**31 - 2, 1): ("sorted", 14, 1, 0, 2, 40 + 512 * 2 + 2 * (2**31 - 2)),  # 4 passes
    (100_000, 40, 10): ("shared", 2, 256, 391, 256 * 40 * 10, 0),  # past 256 slices of 128
    (0, 10, 4): ("shared", 1, 1, 1, 0, 0),
    (0, 100_000, 4): ("sorted", 1, 0, 0, 0, 512 + 2 * 100_000),
}


@pytest.mark.parametrize("shape", list(PLANS), ids=str)
def test_plan_and_launches_by_hand(shape):
    p = tg.plan(*shape)
    assert tuple(p) == PLANS[shape]
    assert tg.launches(*shape) == p.launches


def test_plan_refuses_outside_fits():
    with pytest.raises(ValueError, match="table_grad needs"):
        tg.plan(10, 0, 8)


def test_step_launches_are_the_sum_over_the_step_shapes():
    """chip_smoke.tg_step_launches at the MicroLens defaults: the item table
    sorted (8: a 2-pass key sort, the chunk and row passes), the likes_level
    table shared (2); over row-sharded tables one call a feature."""
    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.config.schema import MeshConfig

    exp = microlens_experiment(data_root="")
    assert sorted(chip_smoke.tg_step_shapes(exp, 4096)) == [(8192, 129, 128),
                                                           (86016, 91777, 128)]
    assert chip_smoke.tg_step_launches(exp) == 8 + 2
    b1024 = microlens_experiment(data_root="", table_optimizer="adam", batch_size=1024)
    assert sorted(chip_smoke.tg_step_shapes(b1024, 1024)) == [(2048, 129, 128),
                                                             (21504, 21506, 128)]
    mp = exp.replace(mesh=MeshConfig(model_parallel=2))
    assert sorted(chip_smoke.tg_step_shapes(mp, 2048)) == [
        (2048, 65, 128), (2048, 65, 128), (2048, 45889, 128), (40960, 45889, 128)]
    assert chip_smoke.tg_step_launches(mp, 2048) == 2 + 2 + 8 + 8


# ------------------------------------------------------------ the kernel's order
def _order_case(case):
    """(ids, rows, E) of each order case, seeded."""
    rng = np.random.default_rng(abs(hash(case)) % 2**32)
    sorted_rows = tg.SHARED_BYTES // (4 * 8) + 1  # E = 8: one row past the shared path
    if case == "run in one sub-chunk":  # each row < SUB ids
        return rng.integers(0, sorted_rows, 3000), sorted_rows, 8
    if case == "run across sub-chunks":  # ~100 ids a row: runs cross warps, inside chunks
        return rng.integers(0, 30, 3000) * 97, sorted_rows, 8
    if case == "run across 2 chunks":
        ids = rng.integers(0, sorted_rows, 2 * tg.CHUNK)
        ids[tg.CHUNK - 40 : tg.CHUNK + 60] = 7
        return ids, sorted_rows, 8
    if case == "one row takes every id":  # hundreds of chunks
        return np.full(300 * tg.CHUNK + 17, 11), sorted_rows, 8
    if case == "untouched rows":
        return rng.integers(0, 50, 900) * 131, sorted_rows, 8
    if case == "cut-off row":
        ids = rng.integers(0, sorted_rows - 1, 2500)
        ids[rng.random(2500) < 0.3] = sorted_rows - 1
        return ids, sorted_rows, 8
    if case == "pad-heavy item table":
        return _pad_heavy(rng, 20_000, 9000), 9000, 32
    if case == "E=10 sorted":
        return rng.integers(0, 5000, 4000), 5000, 10
    if case == "E=10 shared":
        return rng.integers(0, 41, 1500), 41, 10
    if case == "likes_level":
        return rng.integers(0, 10, 8192), 129, 128
    if case == "shared edge inside":  # 160 KiB exactly, 3 slices
        return rng.integers(0, 320, 300), 320, 128
    if case == "shared edge past":  # 4 B more: the sorted path
        return rng.integers(0, 321, 300), 321, 128
    if case == "shared, 256 slices":
        return rng.integers(0, 40, 40_000), 40, 10
    if case == "zero ids, shared":
        return np.zeros(0, np.int64), 10, 4
    if case == "zero ids, sorted":
        return np.zeros(0, np.int64), sorted_rows, 8
    raise KeyError(case)


ORDER_CASES = ["run in one sub-chunk", "run across sub-chunks", "run across 2 chunks",
               "one row takes every id", "untouched rows", "cut-off row", "pad-heavy item table",
               "E=10 sorted", "E=10 shared", "likes_level", "shared edge inside",
               "shared edge past", "shared, 256 slices", "zero ids, shared", "zero ids, sorted"]


@pytest.mark.parametrize("case", ORDER_CASES)
def test_order_matches_jax_and_fp64(case):
    """table_grad_order, the kernel's order in PyTorch, against JAX's
    ``.at[ids].add`` at atol 1e-6, rtol 0 (cotangents at a gradient's scale,
    1e-4, so that fp32 sums of up to ~8e4 terms in two orders stay apart by
    less than 1e-6 while a term lost or counted twice moves a row by ~1e-4)
    and against the fp64 plain version within chip_smoke.TG_NORM_TOL in
    norm; the plan's path as the case names it."""
    ids, rows, e = _order_case(case)
    rng = np.random.default_rng(len(ids) + rows)
    cot = (1e-4 * rng.standard_normal((len(ids), e))).astype(np.float32)
    t_ids, t_cot = torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(cot)
    got = tg.table_grad_order([(t_ids, t_cot)], rows)
    assert got.dtype == torch.float32 and got.shape == (rows, e)
    np.testing.assert_allclose(got.numpy(), _jax_grad(ids, cot, rows), rtol=0, atol=1e-6)
    want = tg.table_grad_plain([(t_ids, t_cot.double())], rows)
    gap = float((got.double() - want).norm() / want.norm()) if len(ids) else 0.0
    assert gap <= chip_smoke.TG_NORM_TOL, gap
    if len(ids) == 0:
        assert not got.any()
    path = tg.plan(len(ids), rows, e).path
    shared = ("E=10 shared", "likes_level", "shared edge inside", "shared, 256 slices",
              "zero ids, shared")
    assert path == ("shared" if case in shared else "sorted"), (case, path)


@pytest.mark.parametrize("k", [1, 2, 3, tg.MAX_SEGMENTS])
@pytest.mark.parametrize("rows", [129, 5000])  # the shared path, the sorted path
def test_segments_equal_their_concatenation(k, rows):
    """A call on k segments, one a transposed (S, B, E) view as the
    mean-pooled history's cotangent comes, is the call on their
    concatenation bit for bit: the plain version, the order mirror and the
    wrapper on the CPU."""
    rng = np.random.default_rng(k * rows)
    segs = []
    for j in range(k):
        if j == 1:  # ids (S, B), cot the transpose of a contiguous (B, S, E)
            ids = torch.from_numpy(rng.integers(0, rows, (5, 37)))
            cot = torch.from_numpy(rng.standard_normal((37, 5, 16)).astype(np.float32))
            segs.append((ids, cot.transpose(0, 1)))
        else:
            n = int(rng.integers(0, 700))
            segs.append((torch.from_numpy(rng.integers(0, rows, n)),
                         torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))))
    flat = [(torch.cat([i.reshape(-1) for i, _ in segs]),
             torch.cat([c.reshape(-1, 16) for _, c in segs]))]
    for fn in (tg.table_grad_plain, tg.table_grad_order, tg.table_grad):
        assert torch.equal(fn(segs, rows), fn(flat, rows)), fn.__name__


@pytest.mark.parametrize("layout", ["contiguous", "transposed", "row slice", "4-d"])
def test_rows_grid_reads_each_segment_in_place(layout):
    """The wrapper's description of a segment's cotangent rows (inner,
    stride_outer, stride_inner: the kernel's addressing) names the rows of
    the tensor autograd gave, in the ids' order, with no copy where such a
    grid holds."""
    base = torch.arange(6 * 7 * 12, dtype=torch.float32)
    cot = {"contiguous": base.view(42, 12),
           "transposed": base.view(7, 6, 12).transpose(0, 1),
           "row slice": base.view(42, 12)[:, 4:],
           "4-d": base.view(2, 3, 7, 12).transpose(1, 2)}[layout]
    e = cot.shape[-1]
    n = cot.numel() // e
    got, inner, so, si = tg._rows_grid(cot, n, e)
    assert (got.data_ptr() == cot.data_ptr()) is (layout != "4-d")
    flat = got.reshape(-1) if layout == "4-d" else base
    offset = (got.data_ptr() - base.data_ptr()) // 4 if layout != "4-d" else 0
    rows = torch.stack([flat[offset + (q // inner) * so + (q % inner) * si:][:e]
                        for q in range(n)])
    assert torch.equal(rows, cot.reshape(n, e))


@pytest.mark.parametrize("rows,e", [(6, 2), (400, 128)])  # the shared path, the sorted path
def test_ids_out_of_range_add_nothing(rows, e):
    """The contract the kernel keeps: an id outside [0, rows) (negative,
    rows, past int32) adds nothing, in the plain version (PyTorch's
    index_add_ would raise) and in the order mirror, on both paths."""
    ids = torch.tensor([3, -1, 5, 2**40, 3, rows, 2**32 + 5])
    cot = torch.arange(7 * e, dtype=torch.float32).view(7, e)
    want = torch.zeros(rows, e)
    want[3] = cot[0] + cot[4]
    want[5] = cot[2]
    assert tg.plan(7, rows, e).path == ("shared" if rows == 6 else "sorted")
    assert torch.equal(tg.table_grad([(ids, cot)], rows), want)
    assert torch.equal(tg.table_grad_order([(ids, cot)], rows), want)
