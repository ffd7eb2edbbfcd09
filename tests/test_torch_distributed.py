"""The port's ``parallel/`` runtime against the JAX package's, on the CPU.

In this process (no process group): ``initialize`` as a clean no-op outside
a cluster and raising on an explicit request that fails; ``make_mesh``'s
layouts and errors (the JAX message for a mesh that does not cover the
ranks);
``param_specs``, ``batch_specs`` and ``opt_state_specs`` against the JAX
ones on the same model; ``host_local_to_global`` on one rank; the bucketed
all-reduce's buckets.

Across two ranks (gloo, one spawn of ``tests/_torch_dp_worker.py``, 120 s
limit, killed past it): ``initialize`` from the launcher's environment,
``host_id`` / ``host_count``, the mesh, the ranks' first rows, the
counterpart of ``tests/test_distributed.py``'s two-process global loss and
gradient (to 1e-5 of its numpy reference), and the refusals: a replica
that differs from rank 0's raises on every rank, and ``fit_on_device``
refuses a global batch that does not divide over the ranks. The 1 x 2
layout (``model_parallel=2``) on the same two ranks: each rank's data and
model rank, world rank 0 alone writing, a Trainer keeping its shard of
each table and of its Adam moments (and of the sparse table optimizer's
state), a replicated leaf that differs across the model group raising on
every rank.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.config.schema import MeshConfig as JaxMeshConfig
from ctr_recommendation_tpu.features import build_feature_map
from ctr_recommendation_tpu.models import build_model as jax_build_model
from ctr_recommendation_tpu.parallel import mesh as jax_mesh
from ctr_recommendation_tpu.parallel import sharding as jax_sharding
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.config.schema import MeshConfig
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm
from ctr_recommendation_tpu_torch.parallel import (
    batch_specs,
    data_parallel,
    distributed,
    make_mesh,
    param_specs,
    single_device_mesh,
    tree_shardings,
)
from ctr_recommendation_tpu_torch.parallel import sharding
from ctr_recommendation_tpu_torch.parallel.mesh import Mesh
from ctr_recommendation_tpu_torch.tools import jax_bridge
from ctr_recommendation_tpu_torch.training.optim import make_optimizer
from tests import _torch_dp_worker as worker
from tests.test_distributed import _numpy_reference

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)


# ------------------------------------------------------------ one process
def test_initialize_noop_outside_cluster(no_launcher):
    """Bare initialize() in a plain single-process environment returns False
    and joins nothing; the rank is 0 of 1."""
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    assert (distributed.host_id(), distributed.host_count()) == (0, 1)
    assert distributed.rank_device("cuda") == torch.device("cuda", 0)
    assert distributed.rank_device("cpu") == torch.device("cpu")


def test_initialize_raises_on_an_explicit_request_that_fails(no_launcher):
    with pytest.raises(ValueError, match="together"):
        distributed.initialize("localhost:1234", 2)
    # rank 1 of 2 with no rank 0 listening: fails after the timeout
    with pytest.raises(RuntimeError):
        distributed.initialize(f"localhost:{worker._free_port()}", 2, 1, backend="gloo",
                               timeout_s=1)
    assert not torch.distributed.is_initialized()


def test_default_backend():
    assert distributed.default_backend("cpu") == "gloo"
    assert distributed.default_backend("cuda:0") == "nccl"


@pytest.mark.parametrize("dp, mp", [(3, 1), (1, 3), (4, 1)])
def test_make_mesh_refuses_a_layout_that_does_not_cover_the_ranks(dp, mp):
    """The JAX package's message, for 2 ranks as for its 2 devices."""
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(JaxMeshConfig(data_parallel=dp, model_parallel=mp),
                           devices=jax.devices()[:2])
    with pytest.raises(ValueError) as got:
        make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp), world=2, device="cpu")
    assert str(got.value) == str(want.value)


def test_make_mesh_refuses_row_sharded_tables(ranks):
    """No longer refused: model_parallel=2 over two ranks is the 1 x 2
    layout (world rank r is model rank r of data rank 0), world rank 0
    alone writes, and a Trainer on it keeps rows [r 128, (r + 1) 128) of
    the 256-row item table and of its Adam moments, 64 of the 128-row
    category table (shared by likes_level and views_level). A layout that does not cover the ranks still
    raises JAX's message."""
    with pytest.raises(ValueError, match="mesh 2x2 does not cover 2 devices"):
        make_mesh(MeshConfig(data_parallel=2, model_parallel=2), world=2, device="cpu")
    for r in (0, 1):
        got = worker.load(ranks, "runtime", r)
        assert got["mp2"] == {"shape": {"data": 1, "model": 2}, "data_rank": 0,
                              "model_rank": r, "writes": r == 0}
        ref = worker.load(ranks, "refusals", r)
        assert ref["mp2_shapes"] == {"trunk/tables/item_id": [128, 16],
                                     "trunk/tables/likes_level": [64, 16]}
        assert ref["mp2_moment"] == [128, 16] and ref["mp2_writes"] == (r == 0)


def test_single_device_mesh(no_launcher):
    for mesh in (make_mesh(device="cpu"), make_mesh(MeshConfig(data_parallel=1), device="cpu"),
                 single_device_mesh(device="cpu")):
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.device_mesh is None and mesh.group("data") is None
        assert mesh.data_rank == 0 and mesh.device == torch.device("cpu")


def test_host_local_to_global_on_one_rank():
    mesh = single_device_mesh(device="cpu")
    batch = {"a": np.arange(12, dtype=np.int32).reshape(6, 2), "b": np.ones(6, np.float32)}
    cols, row0 = distributed.host_local_to_global(batch, mesh)
    assert row0 == 0 and sorted(cols) == ["a", "b"]
    assert cols["a"].device == torch.device("cpu")
    np.testing.assert_array_equal(cols["a"].numpy(), batch["a"])


def _tiny():
    from ctr_recommendation_tpu.config import microlens_experiment
    from ctr_recommendation_tpu.config.loader import microlens_features

    exp = microlens_experiment(data_root="", embedding_dim=16, hidden_units=(32, 16),
                               max_len=8, use_pallas=False)
    return exp.replace(dataset=dataclasses.replace(exp.dataset, features=microlens_features(
        item_vocab=200, cate_vocab=11, max_len=8, mm_dim=24)))


@pytest.mark.parametrize("model", ["mm_fibinet", "sasrec_fibinet"])
@pytest.mark.parametrize("mp", [1, 2])
def test_specs_match_jax(model, mp):
    """Tables row-sharded only under a model axis > 1, everything else
    replicated; batches split on rows; optimizer moments mirror the params."""
    exp = _tiny()
    exp = exp.replace(model=dataclasses.replace(exp.model, model=model))
    fm = build_feature_map(exp.dataset)
    _, jparams, jstate = jax_build_model(fm, exp.model, jax.random.key(0))
    jmesh = jax_mesh.Mesh(np.asarray(jax.devices()[: 2 * mp]).reshape(2, mp), ("data", "model"))
    want = {k: tuple(v) for k, v in _spec_paths(jax_sharding.param_specs(jparams, jmesh)).items()}
    pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
    params, state = jax_bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), jax.tree_util.tree_map(np.asarray, jstate),
        pt_build_fm(pexp.dataset), pexp.model)
    params = jax_bridge.unflatten({k: torch.from_numpy(np.asarray(v))
                                   for k, v in jax_bridge.flatten(params).items()})
    mesh = Mesh({"data": 2, "model": mp}, ("data", "model"), torch.device("cpu"))
    got = param_specs(params, mesh)
    flat = {k: tuple(v) for k, v in _spec_paths(got).items()}
    assert flat == want
    assert any(v == ("model", None) for v in flat.values()) == (mp > 1)
    shardings = tree_shardings(got, mesh)
    assert all(s.mesh is mesh for s in _spec_paths(shardings).values())
    assert batch_specs({"a": 1, "b": 2}) == {"a": ("data",), "b": ("data",)}
    assert batch_specs({"a": 1}) == jax_sharding.batch_specs({"a": 1})
    assert sharding.batch_sharding(mesh).spec == ("data",)
    # the dense chain's state: moments take the leaves' specs, the count P()
    leaves = list(jax_bridge.flatten(params).values())
    tx, _ = make_optimizer(pexp.train, 10)
    opt = tx.init(leaves)
    specs = sharding.opt_state_specs(opt, [s for s in _spec_paths(got).values()], leaves)
    assert specs["count"] == () and specs["mu"] == list(_spec_paths(got).values())


def _spec_paths(tree, prefix=""):
    """{path: PartitionSpec or NamedSharding}: flatten without entering the
    specs (which are tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_paths(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_spec_paths(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


def test_put_global_on_one_rank_returns_the_tree():
    mesh = single_device_mesh(device="cpu")
    tree = {"w": torch.ones(3), "b": [torch.zeros(2)]}
    assert sharding.put_global(tree, tree_shardings(param_specs(tree, mesh), mesh)) is tree


def test_buckets_group_by_size_and_dtype(monkeypatch):
    """all_reduce_buckets_ without a peer: the calls it makes (one a
    bucket) and that every tensor comes back in place."""
    calls = []
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda t, group=None: calls.append((t.dtype, t.numel())) or t.mul_(2))
    ts = [torch.ones(10), torch.ones(4, 5).t(), torch.ones(3, dtype=torch.int64),
          torch.ones(100), torch.ones(2)]
    data_parallel.all_reduce_buckets_(ts, group=None, bucket_bytes=200)
    # [10 + 20 floats], [3 int64], [100 floats alone: over the cap], [2 floats]
    assert calls == [(torch.float32, 30), (torch.int64, 3), (torch.float32, 100),
                     (torch.float32, 2)]
    assert all(bool((t == 2).all()) for t in ts)


# ------------------------------------------------------------ two ranks
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist"))
    exp = _tiny()
    fm = build_feature_map(exp.dataset)
    _, jparams, jstate = jax_build_model(fm, exp.model, jax.random.key(0))
    pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
    params, state = jax_bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), jax.tree_util.tree_map(np.asarray, jstate),
        pt_build_fm(pexp.dataset), pexp.model)
    weights = os.path.join(root, "w.npz")
    jax_bridge.save(weights, params, state)
    cases = [{"kind": "runtime", "name": "runtime"},
             {"kind": "refusals", "name": "refusals", "experiment": pt_serialize.to_json(pexp),
              "weights": weights, "ckpt": os.path.join(root, "ckpt")}]
    out = os.path.join(root, "out")
    worker.run_ranks(cases, out)
    return out


def test_two_ranks_initialize_from_the_launchers_environment(ranks):
    for r in (0, 1):
        got = worker.load(ranks, "runtime", r)
        assert got["again"] is True  # idempotent
        assert (got["host_id"], got["host_count"]) == (r, 2)
        assert got["mesh_shape"] == {"data": 2, "model": 1} and got["data_rank"] == r
        # each rank's first global row: rank x local rows (5 rows; 6 on axis 1)
        assert (got["row0"], got["row0_k"]) == (5 * r, 6 * r)
        assert got["errors"]["dp3"].startswith("ValueError: mesh 3x1 does not cover 2 devices")
        assert "mp2" not in got["errors"]  # model_parallel=2 lays out 1 x 2


def test_two_process_global_loss_matches_single_process(ranks):
    """The counterpart of tests/test_distributed.py's: each rank's share of
    mean(emb[ids].sum(-1) * y) over its 32 rows, loss and gradient summed
    across the ranks."""
    want_loss, want_gnorm = _numpy_reference()
    for r in (0, 1):
        got = worker.load(ranks, "runtime", r)
        assert got["loss"] == pytest.approx(want_loss, abs=1e-5)
        assert got["gnorm"] == pytest.approx(want_gnorm, abs=1e-5)


def test_two_ranks_refuse_a_differing_replica_and_an_undivided_batch(ranks):
    for r in (0, 1):
        got = worker.load(ranks, "refusals", r)
        assert "data rank(s) [1] differ from rank 0's" in got["replica"]
        assert "does not divide over 2 data-parallel ranks" in got["batch"]
        # at 1 x 2 the replicated leaves are held equal across the model group
        assert "replicated parameters of model rank(s) [1] differ" in got["mp2_replica"]


def test_sparse_tables_at_model_parallel_shard_their_state(ranks):
    """No longer refused: at 1 x 2 the sparse table optimizer's state (lazy
    Adam's moments) is sharded like the tables it mirrors."""
    for r in (0, 1):
        assert worker.load(ranks, "refusals", r)["mp2_sparse"] == {
            "item_id/mu": [128, 16], "item_id/nu": [128, 16],
            "likes_level/mu": [64, 16], "likes_level/nu": [64, 16]}
