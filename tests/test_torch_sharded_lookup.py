"""The port's row-sharded lookup (``parallel/embedding.py``) across gloo
ranks on the CPU against the JAX package's ``sharded_lookup`` on conftest's
fake CPU devices and against the plain gather.

One spawn a layout, 1 x 2 (two ranks) and 2 x 2 (four), through
``tests/_torch_dp_worker.py`` (120 s limit, killed past it): every rank runs
every lookup of ``lookup_scenarios()`` (numpy-seeded tables and ids; flat
and sequence ids, both methods, a batch whose ids all sit in shard 0 at
capacity factor 1.1, out-of-range ids, pad exclusion, the small-table
passthrough, a pad id read from the feature map) and saves its rows, its
shard's gradient of the scenario's loss (summed over the data group) and
the exchange's counters. Tolerances:

* the rows: bit for bit JAX's ``sharded_lookup`` (or ``make_sharded_lookup``)
  on the same (dp, mp) mesh, and bit for bit ``table[ids]`` with zero rows
  for ids out of range and for excluded pad ids: the forward is a gather
  plus zeros;
* the gradient, assembled from the model ranks' shards: the plain
  scatter-add of the cotangents within rtol 1e-6 (another order of fp32
  sums), JAX's within 1e-6 too; repeated id 3 exactly 4.0, also through the
  overflow fallback, which a backward that summed the model ranks'
  identical cotangents would double;
* the counters: ``all_to_all``'s row buffer cap x mp x E floats, psum's
  n x E, and the fallback taken on every rank together.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from ctr_recommendation_tpu.config.schema import MeshConfig as JaxMeshConfig
from ctr_recommendation_tpu.parallel import embedding as jax_embedding
from ctr_recommendation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ctr_recommendation_tpu_torch.parallel import embedding
from tests import _torch_dp_worker as worker

LAYOUTS = [(1, 2), (2, 2)]
SCENARIOS = {sc["name"]: sc for sc in worker.lookup_scenarios()}
STAT = {k: i for i, k in enumerate(worker.LOOKUP_STATS)}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """{(dp, mp): [each world rank's outputs]} from one spawn a layout."""
    root = tmp_path_factory.mktemp("lookup")
    out = {}
    for dp, mp in LAYOUTS:
        path = str(root / f"{dp}x{mp}")
        worker.run_ranks([{"kind": "lookup", "name": "lookup", "mp": mp}], path, world=dp * mp)
        out[(dp, mp)] = [worker.load(path, "lookup", r) for r in range(dp * mp)]
    return out


def _global_rows(ranks, layout, name):
    """The global batch's rows: each data group's model rank 0's rows."""
    dp, mp = layout
    return np.concatenate([ranks[d * mp][f"{name}/rows"] for d in range(dp)])


def _whole_grad(ranks, layout, name):
    """The whole table's gradient: data rank 0's model ranks' shards."""
    return np.concatenate([ranks[m][f"{name}/grad"] for m in range(layout[1])])


def _plain(sc):
    """(rows, gradient) of the plain gather: zeros and no gradient for ids
    out of range or excluded as pads."""
    table, ids = sc["table"], sc["ids"]
    keep = (ids >= 0) & (ids < len(table))
    if sc["pad"] is not None:
        keep &= ids != sc["pad"]
    rows = np.where(keep[..., None], table[np.clip(ids, 0, len(table) - 1)], 0).astype(np.float32)
    cot = np.full_like(rows, 2.0) if sc["loss"] == "x2" else 2.0 * rows
    grad = np.zeros_like(table)
    np.add.at(grad, ids[keep], cot[keep])
    return rows, grad


_JAX: dict = {}


def _jax(sc, layout):
    """(rows, gradient) of the JAX package's lookup on the same mesh."""
    key = (sc["name"], layout)
    if key not in _JAX:
        dp, mp = layout
        mesh = jax_make_mesh(JaxMeshConfig(data_parallel=dp, model_parallel=mp),
                             devices=jax.devices()[: dp * mp])
        table = jax.device_put(jnp.asarray(sc["table"]), NamedSharding(mesh, P("model", None)))
        ids = jax.device_put(jnp.asarray(sc["ids"]),
                             NamedSharding(mesh, P("data", *([None] * (sc["ids"].ndim - 1)))))
        if sc["via"] == "make":
            from ctr_recommendation_tpu.config import microlens_experiment
            from ctr_recommendation_tpu.config.loader import microlens_features
            from ctr_recommendation_tpu.features import build_feature_map

            exp = microlens_experiment(data_root="", embedding_dim=16, max_len=8)
            fm = build_feature_map(dataclasses.replace(exp.dataset, features=microlens_features(
                item_vocab=200, cate_vocab=11, max_len=8, mm_dim=24)))
            fn = jax_embedding.make_sharded_lookup(
                mesh, feature_map=fm, small_table_rows=sc["small"], method=sc["method"],
                capacity_factor=sc["cap"])

            def look(t):
                return fn({sc["table_name"]: t}, sc["table_name"], ids)
        else:
            def look(t):
                return jax_embedding.sharded_lookup(t, ids, mesh, method=sc["method"],
                                                    capacity_factor=sc["cap"], pad_id=sc["pad"])

        def loss(t):
            r = look(t)
            return jnp.sum(r * 2.0) if sc["loss"] == "x2" else jnp.sum(r**2)

        _JAX[key] = (np.asarray(jax.jit(look)(table)), np.asarray(jax.jit(jax.grad(loss))(table)))
    return _JAX[key]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_rows_bit_for_bit_jax_and_the_plain_gather(spawned, layout, name):
    sc = SCENARIOS[name]
    ranks = spawned[layout]
    got = _global_rows(ranks, layout, name)
    want, _ = _plain(sc)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax(sc, layout)[0])
    # replicated over the model group: every model rank holds the same rows
    dp, mp = layout
    for r in range(dp * mp):
        np.testing.assert_array_equal(ranks[r][f"{name}/rows"],
                                      ranks[(r // mp) * mp][f"{name}/rows"], err_msg=f"rank {r}")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_gradient_is_the_scatter_add(spawned, layout, name):
    """The table's gradient, assembled from the owners' shards, is the plain
    scatter-add of the cotangents (and JAX's), on every data rank."""
    sc = SCENARIOS[name]
    ranks = spawned[layout]
    got = _whole_grad(ranks, layout, name)
    _, want = _plain(sc)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, _jax(sc, layout)[1], rtol=1e-6, atol=1e-6)
    dp, mp = layout
    for r in range(mp, dp * mp):  # the data group summed the same shard
        np.testing.assert_array_equal(ranks[r][f"{name}/grad"], ranks[r % mp][f"{name}/grad"])


@pytest.mark.parametrize("method", ["psum", "all_to_all"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_repeated_id_accumulates_once(spawned, layout, method):
    """ids [3, 3, 7, 99], loss sum(2 rows): row 3's gradient is exactly 4.0
    (8.0 from a backward that summed the two model ranks' cotangents),
    rows 7 and 99 exactly 2.0; at 1 x 2 the 4 ids overflow a bucket of 3
    and the all_to_all takes its fallback."""
    grad = _whole_grad(spawned[layout], layout, f"repeat_{method}")
    assert (grad[3] == 4.0).all() and (grad[7] == 2.0).all() and (grad[99] == 2.0).all()
    assert np.count_nonzero(grad.any(axis=1)) == 3


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_overflow_takes_the_fallback_on_every_rank(spawned, layout):
    """Every id in shard 0 at capacity factor 1.1: every rank of every model
    group counts one fallback (the overflow count is all-reduced); balanced
    ids and the psum method none."""
    for res in spawned[layout]:
        assert res["skew_all_to_all/stats"][STAT["fallbacks"]] == 1
        assert res["fallback_grad/stats"][STAT["fallbacks"]] == 1
        for name in ("flat_all_to_all", "seq_all_to_all", "pad_all_to_all", "fm_pad",
                     "bytes_all_to_all", "skew_psum"):
            assert res[f"{name}/stats"][STAT["fallbacks"]] == 0, name


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_row_buffers_are_cap_by_mp_against_psums_n(spawned, layout):
    """1024 ids a global batch, E=128: a rank's all_to_all sends and
    receives a row buffer of cap x mp x E floats, cap = ceil(1.25 n / mp),
    plus its id buffer and one count; psum all-reduces n x E floats. On the
    wire a ring all-reduce sends 2 (mp - 1) / mp of its buffer, an
    all-to-all (mp - 1) / mp of its: the exchange moves less."""
    dp, mp = layout
    n, e = 1024 // dp, 128
    cap = -(-int(1.25 * n) // mp)
    for res in spawned[layout]:
        a2a, ps = res["bytes_all_to_all/stats"], res["bytes_psum/stats"]
        assert a2a[STAT["row_bytes"]] == cap * mp * e * 4
        assert a2a[STAT["bytes"]] == cap * mp * e * 4 + cap * mp * 4 + 8
        assert a2a[STAT["calls"]] == 3  # ids out, rows back, the overflow count
        assert ps[STAT["row_bytes"]] == ps[STAT["bytes"]] == n * e * 4
        assert ps[STAT["calls"]] == 1
        assert (mp - 1) / mp * a2a[STAT["row_bytes"]] < 2 * (mp - 1) / mp * ps[STAT["row_bytes"]]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_pad_exclusion_keeps_pads_out_of_the_exchange(spawned, layout):
    """Half the ids are the pad 0, all owned by model rank 0: excluded, the
    largest bucket holds the real ids only and nothing overflows
    (``exchange_stats`` on the same ids agrees); without exclusion the pad
    owner's bucket overflows."""
    dp, mp = layout
    ids = SCENARIOS["pad_all_to_all"]["ids"]
    with_pad = embedding.exchange_stats(ids, vocab_rows=256, dp=dp, mp=mp, pad_id=0)
    without = embedding.exchange_stats(ids, vocab_rows=256, dp=dp, mp=mp)
    assert with_pad["overflow"] == 0 and without["overflow"] > 0
    for res in spawned[layout]:
        assert res["pad_all_to_all/stats"][STAT["fallbacks"]] == 0
        assert res["fm_pad/stats"][STAT["fallbacks"]] == 0


def _stats_cases():
    rng = np.random.default_rng(4)
    vocab = 256
    skew = np.full(32, 1, np.int32)
    balanced = (np.arange(32) % 4) * (vocab // 4) + 1
    pads = np.where(rng.random((64, 20)) < 0.6, 0, rng.integers(1, 200, (64, 20)))
    return [
        ("skew_and_balanced", np.concatenate([skew, balanced]).astype(np.int32), 2, 4, 0),
        ("all_pads", np.zeros(64, np.int32), 2, 4, 0),
        ("out_of_range", np.asarray([3, -1, vocab, 7, vocab + 99, 5, 2, 1], np.int32), 2, 2,
         None),
        ("padded_history", pads.astype(np.int32), 1, 2, 0),
        ("padded_history_no_pad", pads.astype(np.int32), 2, 2, None),
        ("uniform", rng.integers(0, vocab, (512, 21)).astype(np.int32), 1, 2, 0),
        ("local_gather", rng.integers(0, vocab, (64,)).astype(np.int32), 4, 1, 0),
    ]


@pytest.mark.parametrize("factor", [1.1, 1.25])
@pytest.mark.parametrize("name, ids, dp, mp, pad", _stats_cases(),
                         ids=[c[0] for c in _stats_cases()])
def test_exchange_stats_equals_jax(name, ids, dp, mp, pad, factor):
    kw = dict(vocab_rows=256, dp=dp, mp=mp, capacity_factor=factor, pad_id=pad)
    assert embedding.exchange_stats(ids, **kw) == jax_embedding.exchange_stats(ids, **kw)


def test_constants_match_jax():
    assert embedding.VOCAB_ROUND == jax_embedding.VOCAB_ROUND
    assert embedding.DEFAULT_CAPACITY_FACTOR == jax_embedding.DEFAULT_CAPACITY_FACTOR
    assert embedding.SMALL_TABLE_ROWS == jax_embedding.SMALL_TABLE_ROWS
    for v in (1, 11, 128, 129, 200, 91718):
        assert embedding.round_up_vocab(v) == jax_embedding.round_up_vocab(v)


def test_one_rank_is_the_trunks_gather():
    """At mp == 1 (no process group) both entry points are the trunk's
    gather: negative ids count from the end, out-of-range ids clamp."""
    import torch

    from ctr_recommendation_tpu_torch.models.trunk import gather
    from ctr_recommendation_tpu_torch.parallel.mesh import single_device_mesh

    mesh = single_device_mesh(device="cpu")
    table = torch.from_numpy(np.random.default_rng(0).standard_normal((128, 8)).astype(np.float32))
    ids = torch.tensor([[0, 5, -1], [127, 200, 3]])
    want = gather(table, ids)
    assert torch.equal(embedding.sharded_lookup(table, ids, mesh), want)
    assert torch.equal(embedding.make_sharded_lookup(mesh)({"t": table}, "t", ids), want)
    with pytest.raises(ValueError, match="unknown lookup method"):
        mesh2 = dataclasses.replace(mesh, shape={"data": 1, "model": 2})
        embedding.sharded_lookup(table, ids, mesh2, method="gather")
