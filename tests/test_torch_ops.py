"""PyTorch port ops == JAX package ops on the same numpy inputs (CPU).

Inputs and weights come from numpy seeds (or the JAX package's own init,
converted to numpy) and go through both implementations. fp32 results agree
to float32 summation-order noise (rtol 1e-4, atol 1e-5); bf16 results to
bf16 rounding, since the two frameworks round at different places.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.data import device_store as jax_store
from ctr_recommendation_tpu.data import wire as jax_wire
from ctr_recommendation_tpu.features import build_feature_map as jax_build_fm
from ctr_recommendation_tpu.features import hashing as jax_hashing
from ctr_recommendation_tpu.models import trunk as jax_trunk
from ctr_recommendation_tpu.ops import bilinear as jax_bilinear
from ctr_recommendation_tpu.ops import interaction as jax_interaction
from ctr_recommendation_tpu.ops import mlp as jax_mlp
from ctr_recommendation_tpu.ops import pooling as jax_pooling
from ctr_recommendation_tpu.ops import senet as jax_senet
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.data import device_store as pt_store
from ctr_recommendation_tpu_torch.data import wire as pt_wire
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm
from ctr_recommendation_tpu_torch.features import hashing as pt_hashing
from ctr_recommendation_tpu_torch.models import trunk as pt_trunk
from ctr_recommendation_tpu_torch.ops import bilinear as pt_bilinear
from ctr_recommendation_tpu_torch.ops import interaction as pt_interaction
from ctr_recommendation_tpu_torch.ops import mlp as pt_mlp
from ctr_recommendation_tpu_torch.ops import pooling as pt_pooling
from ctr_recommendation_tpu_torch.ops import senet as pt_senet
from ctr_recommendation_tpu_torch.utils.tree import tree_map
from tests.conftest import make_batch

torch.set_num_threads(2)

FP32 = dict(rtol=1e-4, atol=1e-5)


def to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def to_pt(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def pt_exp(jax_exp):
    """The same experiment in the port's (copied) config classes."""
    from ctr_recommendation_tpu.config import serialize as jax_serialize

    return pt_serialize.from_json(jax_serialize.to_json(jax_exp))


def field_stack(b=24, f=6, e=32, seed=0):
    return np.random.default_rng(seed).standard_normal((b, f, e)).astype(np.float32)


def test_senet_matches_jax():
    x = field_stack()
    params = to_np(jax_senet.init(jax.random.key(1), 6, 2))
    want = np.asarray(jax_senet.apply(params, jnp.asarray(x)))
    got = pt_senet.apply(to_pt(params), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("btype", ["all", "each"])
def test_bilinear_matches_jax(btype):
    x = field_stack(seed=1)
    params = to_np(jax_bilinear.init(jax.random.key(2), 32, 6, btype))
    want = np.asarray(jax_bilinear.apply(params, jnp.asarray(x), btype))
    got = pt_bilinear.apply(to_pt(params), torch.from_numpy(x), btype).numpy()
    np.testing.assert_allclose(got, want, **FP32)


def test_pair_indices_keep_triu_order():
    i_pt, j_pt = pt_bilinear.pair_indices(6)
    i_jx, j_jx = jax_bilinear.pair_indices(6)
    np.testing.assert_array_equal(i_pt, i_jx)
    np.testing.assert_array_equal(j_pt, j_jx)


@pytest.mark.parametrize("btype", ["all", "each"])
def test_interaction_reference_matches_jax(btype):
    x = field_stack(seed=2)
    sp = to_np(jax_senet.init(jax.random.key(3), 6, 2))
    bp = to_np(jax_bilinear.init(jax.random.key(4), 32, 6, btype))
    want = np.asarray(jax_interaction.senet_bilinear_concat_reference(
        sp, bp, jnp.asarray(x), bilinear_type=btype))
    got = pt_interaction.senet_bilinear_concat_reference(
        to_pt(sp), to_pt(bp), torch.from_numpy(x), bilinear_type=btype).numpy()
    np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_mean_t_matches_jax(dtype):
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((8, 16, 32)).astype(np.float32)
    ids = np.where(rng.random((8, 16)) < 0.4, 0, rng.integers(1, 50, (8, 16))).astype(np.int32)
    ids[:, 0] = 0  # an all-pad row: the count clamps at 1
    want = np.asarray(
        jax_pooling.masked_mean_t(jnp.asarray(emb, dtype), jnp.asarray(ids), 0), np.float32)
    got = pt_pooling.masked_mean_t(
        torch.from_numpy(emb).to(getattr(torch, dtype)), torch.from_numpy(ids), 0).float().numpy()
    # bf16: a 16-term mean rounded once in either framework
    tol = FP32 if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(got, want, **tol)


def _mlp_with_stats():
    rng = np.random.default_rng(6)
    params, state = jax_mlp.init(jax.random.key(5), 96, [32, 16], batch_norm=True)
    params, state = to_np(params), to_np(state)
    for layer, st in zip(params["layers"], state["layers"]):
        d = st["bn_mean"].shape[0]
        st["bn_mean"] = rng.normal(0, 0.3, d).astype(np.float32)
        st["bn_var"] = rng.uniform(0.5, 2.0, d).astype(np.float32)
        layer["bn_scale"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
        layer["bn_bias"] = rng.normal(0, 0.1, d).astype(np.float32)
    x = rng.standard_normal((24, 96)).astype(np.float32)
    return params, state, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_eval_apply_matches_jax(dtype):
    params, state, x = _mlp_with_stats()
    want, _ = jax_mlp.apply(params, state, jnp.asarray(x, dtype), train=False)
    got, _ = pt_mlp.apply(
        to_pt(params), to_pt(state), torch.from_numpy(x).to(getattr(torch, dtype)))
    # bf16: matmuls, BatchNorm and ReLU all in bf16 in both frameworks
    tol = FP32 if dtype == "float32" else dict(atol=5e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_fold_batch_norm_matches_jax():
    params, state, x = _mlp_with_stats()
    want = to_np(jax_mlp.fold_batch_norm(params, state))
    got = pt_mlp.fold_batch_norm(to_pt(params), to_pt(state))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_w) == 6
    for (gl, wl) in zip(got["layers"], want["layers"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(gl["linear"][k].numpy(), wl["linear"][k], **FP32)
    # the folded tower is the eval tower
    folded_state = {"layers": [{}, {}]}
    np.testing.assert_allclose(
        pt_mlp.apply(got, folded_state, torch.from_numpy(x))[0].numpy(),
        np.asarray(jax_mlp.apply(params, state, jnp.asarray(x), train=False)[0]),
        **FP32,
    )


def test_hash_ids_matches_jax_on_negative_and_out_of_range():
    ids = np.array(
        [0, 1, 5, -1, -7, 2**31 - 1, -(2**31), 91717, 91718, 10**9, 123456789],
        dtype=np.int32,
    )
    for buckets, pad in ((1000, 0), (2, 0), (65537, 3)):
        want = np.asarray(jax_hashing.hash_ids(jnp.asarray(ids), buckets, pad))
        got = pt_hashing.hash_ids(torch.from_numpy(ids), buckets, pad)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_device_join_gives_zero_rows_out_of_range():
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((10, 4)).astype(np.float32)
    ids = np.array([0, 3, 9, 10, 11, -1, -10, 2**31 - 1], np.int32)
    want = np.asarray(jax_store.DeviceItemStore(jnp.asarray(emb)).lookup(jnp.asarray(ids)))
    got = pt_store.DeviceItemStore(torch.from_numpy(emb)).lookup(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[3:], 0.0)
    feats = pt_store.device_join(
        {"item_id": torch.from_numpy(ids)}, {"item_emb_d128": torch.from_numpy(emb)},
        [("item_emb_d128", "item_id")],
    )
    np.testing.assert_array_equal(feats["item_emb_d128"].numpy(), want)


def _wire_cols(n, vocab, max_len, seed):
    rng = np.random.default_rng(seed)
    cols = {
        "likes_level": rng.integers(0, 11, n, dtype=np.int32),
        "views_level": rng.integers(0, 11, n, dtype=np.int32),
        "item_id": rng.integers(1, vocab, n, dtype=np.int32),
        "item_seq": np.where(
            rng.random((n, max_len)) < 0.4, 0, rng.integers(1, vocab, (n, max_len))
        ).astype(np.int32),
    }
    cols["item_seq"][0] = 0  # all pad
    cols["item_seq"][1, :-1] = 0  # singleton
    cols["item_seq"][2, 2] = 0  # an interior pad id survives
    return cols


@pytest.mark.parametrize("full", [False, True], ids=["u8", "u16b"])
def test_wire_roundtrip_matches_jax_unpack(tiny_experiment, full):
    """Port pack -> port unpack is exact, and the port's torch unpacker reads
    the JAX package's packed bytes the same way JAX does (u8, u16 + packed
    17th bit, ragged left-padded sequences, a short final chunk)."""
    if full:
        from ctr_recommendation_tpu.config import microlens_experiment

        jexp, vocab, max_len, n = microlens_experiment(data_root=""), 91718, 20, 257
    else:
        jexp, vocab, max_len, n = tiny_experiment, 200, 8, 300
    cols = _wire_cols(n, vocab, max_len, seed=8)
    if full:
        cols["item_id"][3:6] = [91717, 65535, 65536]
    plan = pt_wire.build_wire_plan(pt_build_fm(pt_exp(jexp).dataset))
    assert {e.code for e in plan.entries if e.name == "item_id"} == {"u16b" if full else "u8"}
    buf, layout = pt_wire.pack_columns(cols, plan, n + 5)
    jbuf, jlayout = jax_wire.pack_columns(cols, jax_wire.build_wire_plan(jax_build_fm(jexp.dataset)), n + 5)
    np.testing.assert_array_equal(buf, jbuf)
    got = pt_wire.build_unpacker(layout)(torch.from_numpy(buf))
    want = jax_wire.build_unpacker(jlayout)(jnp.asarray(jbuf))
    for name, col in cols.items():
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy()[:n], col, err_msg=name)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


def test_wire_i32_hashed_ids_roundtrip():
    """Hashed tables ship raw int32 ids, negatives included."""
    from ctr_recommendation_tpu_torch.config.schema import FeatureSpec, FeatureType
    from ctr_recommendation_tpu_torch.config.schema import DatasetConfig

    ds = DatasetConfig("h", (FeatureSpec("uid", FeatureType.CATEGORICAL, hash_buckets=64),))
    plan = pt_wire.build_wire_plan(pt_build_fm(ds))
    assert plan.entries[0].code == "i32"
    ids = np.array([0, -1, 2**31 - 1, -(2**31), 12345, -99], np.int32)
    buf, layout = pt_wire.pack_columns({"uid": ids}, plan, len(ids))
    np.testing.assert_array_equal(
        pt_wire.build_unpacker(layout)(torch.from_numpy(buf))["uid"].numpy(), ids)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trunk_matches_jax(tiny_experiment, dtype):
    exp = tiny_experiment
    jfm = jax_build_fm(exp.dataset)
    params = to_np(jax_trunk.init(jax.random.key(9), jfm, exp.model))
    batch = make_batch(np.random.default_rng(10), 32)
    batch["item_id"][:2] = [-3, 500]  # out of range: both clamp the same way
    want = jax_trunk.apply(
        jax.tree_util.tree_map(jnp.asarray, params), jfm, exp.model, {k: jnp.asarray(v) for k, v in batch.items()},
        compute_dtype=jnp.dtype(dtype))
    pexp = pt_exp(exp)
    got = pt_trunk.apply(
        to_pt(params), pt_build_fm(pexp.dataset), pexp.model,
        {k: torch.from_numpy(v) for k, v in batch.items()},
        compute_dtype=getattr(torch, dtype))
    assert tuple(got.shape) == (32, 6, 16) and got.dtype == getattr(torch, dtype)
    # bf16: the LayerNorm'd projection and the pooled mean round once each
    tol = FP32 if dtype == "float32" else dict(atol=3e-2, rtol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_trunk_tables_padded_to_128_rows(tiny_experiment):
    pexp = pt_exp(tiny_experiment)
    fm = pt_build_fm(pexp.dataset)
    params = pt_trunk.init(torch.Generator().manual_seed(0), fm, pexp.model)
    jparams = jax_trunk.init(jax.random.key(0), jax_build_fm(tiny_experiment.dataset),
                             tiny_experiment.model)
    for name, t in params["tables"].items():
        assert t.shape == jparams["tables"][name].shape
        assert t.shape[0] % 128 == 0
    # the attention and DIN branches build the JAX tree's encoder and
    # activation unit
    from ctr_recommendation_tpu_torch.tools.jax_bridge import flatten

    for pooling, leaf in (("attention", "item_seq/blocks/0/ffn1/w"),
                          ("din", "item_seq/layers/0/alpha")):
        attn = pt_trunk.init(torch.Generator(), fm, pexp.model, seq_pooling=pooling)["attn"]
        jattn = jax_trunk.init(jax.random.key(0), jax_build_fm(tiny_experiment.dataset),
                               tiny_experiment.model, seq_pooling=pooling)["attn"]
        assert {k: tuple(v.shape) for k, v in flatten(attn).items()} == {
            k: tuple(np.shape(v)) for k, v in flatten(jattn).items()
        }
        assert leaf in flatten(attn)
