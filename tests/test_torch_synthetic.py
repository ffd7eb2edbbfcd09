"""The port's ``fake_batch`` and ``masked_sum`` against the JAX package's, on
the CPU: ``fake_batch`` from the same numpy generator state gives the same
keys, dtypes and arrays bit for bit and leaves the generator where the JAX
one leaves it; ``masked_sum`` agrees with the JAX one in fp32 and, in bf16,
with the JAX fp32 sum of the same bf16 inputs, and an all-pad row sums to
exactly 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.data.synthetic import fake_batch as jax_fake_batch
from ctr_recommendation_tpu.ops.pooling import masked_sum as jax_masked_sum
from ctr_recommendation_tpu_torch.data import fake_batch
from ctr_recommendation_tpu_torch.ops.pooling import masked_sum

torch.set_num_threads(2)

SHAPES = {
    "microlens": {},  # the defaults: item_vocab 91718, max_len 20, mm_dim 128
    "narrow": {"item_vocab": 64, "max_len": 4, "mm_dim": 8},
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("with_label", [True, False])
@pytest.mark.parametrize("n", [1, 7, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_fake_batch_is_the_jax_fake_batch(seed, n, with_label, shape):
    kw = dict(SHAPES[shape], with_label=with_label)
    rng, jax_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    got = fake_batch(rng, n, **kw)
    want = jax_fake_batch(jax_rng, n, **kw)
    assert list(got) == list(want)
    expected = ["user_id", "likes_level", "views_level", "item_id", "item_emb_d128", "item_seq"]
    assert list(got) == expected + (["label", "__weight__"] if with_label else [])
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].dtype == (np.float32 if k in ("item_emb_d128", "label", "__weight__")
                                else np.int32), k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k  # bit for bit
    mm_dim, max_len = kw.get("mm_dim", 128), kw.get("max_len", 20)
    assert got["item_emb_d128"].shape == (n, mm_dim) and got["item_seq"].shape == (n, max_len)
    assert rng.bit_generator.state == jax_rng.bit_generator.state
    assert rng.random(3).tobytes() == jax_rng.random(3).tobytes()


def _pooling_inputs(pad_id: int):
    rng = np.random.default_rng(5 + pad_id)
    emb = rng.standard_normal((5, 7, 16)).astype(np.float32)
    ids = rng.integers(0, 6, (5, 7)).astype(np.int32)
    ids[2] = pad_id  # a row that is all pad
    ids[4, :3] = pad_id  # and one left-padded
    return emb, ids


@pytest.mark.parametrize("pad_id", [0, 3])
def test_masked_sum_fp32_against_jax(pad_id):
    emb, ids = _pooling_inputs(pad_id)
    got = masked_sum(torch.from_numpy(emb), torch.from_numpy(ids), pad_id)
    want = np.asarray(jax_masked_sum(jnp.asarray(emb), jnp.asarray(ids), pad_id))
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (got[2] == 0).all()
    assert np.abs(want).max() > 0.5  # the sums are not all near 0


@pytest.mark.parametrize("pad_id", [0, 3])
def test_masked_sum_bf16_against_the_fp32_sum(pad_id):
    """In bf16 the sum comes back in bf16: within 2^-7 relative of the JAX
    fp32 masked_sum of the same (bf16) inputs."""
    emb, ids = _pooling_inputs(pad_id)
    x = torch.from_numpy(emb).bfloat16()
    got = masked_sum(x, torch.from_numpy(ids), pad_id)
    want = np.asarray(jax_masked_sum(jnp.asarray(x.float().numpy()), jnp.asarray(ids), pad_id))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (5, 16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7, atol=0)
    assert (got[2] == 0).all()
