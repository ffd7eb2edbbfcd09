"""The SASRec encoder at every history length and width the JAX kernel runs
(CPU): the streamed attention, the zero-padded widths, SASRec's MovieLens-1M
shape (S = 200, E = 50, two blocks).

Past what shared memory holds the port's attention streams its keys in
tiles (``encoder_blocks.attention_fwd_streamed`` / ``attention_bwd_streamed``;
the kernels cannot run here, their plain versions, which ``encode_fwd_plain``
and ``encode_bwd_plain`` are composed of, do), and widths off the kernels'
multiples run zero-padded (``sasrec_encoder.padded_dims``). Each is held
against the JAX package on the same numpy-seeded inputs: the attention
twins against the JAX kernel's ``_attn_fwd`` / ``_attn_bwd``, the encoder
against the JAX ``fused_encode`` in Pallas interpret mode, the model
against the JAX model and Predictor. On the card chip_smoke.py's phase 7e
holds the kernels against these twins.

Tolerances, each with its reason:
- the attention twins against the JAX helpers and the staged twins: fp32
  2e-6 of the output's largest magnitude (the same fp32 operations, summed
  in another order and, streamed, with the online softmax's rescaling);
  P rebuilt from the stats against JAX's softmax: 2e-6 absolute;
- the padded path against the unpadded plain version: exactly equal (the
  padding adds zero terms to sums taken in fp64 and rounded once, and the
  LayerNorm, the scale and the dropout masks see the true widths);
- ``fused_encode`` against the JAX kernel: the bars of
  tests/test_torch_sasrec.py and tests/test_torch_sasrec_training.py (fp32
  forward 3e-6, bf16 one bf16 ulp of the largest magnitude; fp32 gradients
  rtol 1e-5 / atol 1e-6 of the leaf's largest), the bf16 gradients as
  tests/test_torch_encoder_blocks.py holds them at L = 2: the two bf16
  backwards at most half as far apart as the port's bf16 backward lies from
  its fp32 one (a rounding cascade through two layers);
- the model: the bars of tests/test_torch_predictor.py (fp32 rtol 1e-4 /
  atol 1e-5) and of tests/test_torch_sasrec_training.py's train step (loss
  rtol 1e-5, gradients rtol 1e-4 / atol 1e-5 of the leaf's largest).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.data import ItemStore as JaxItemStore
from ctr_recommendation_tpu.inference import Predictor as JaxPredictor
from ctr_recommendation_tpu.ops.pallas import sasrec_encoder as jax_enc
from ctr_recommendation_tpu.training import bce_with_logits as jax_bce
from ctr_recommendation_tpu_torch.data import ItemStore
from ctr_recommendation_tpu_torch.inference import Predictor
from ctr_recommendation_tpu_torch.models import get_model
from ctr_recommendation_tpu_torch.ops.cuda import encoder_blocks as eb
from ctr_recommendation_tpu_torch.ops.cuda import sasrec_encoder as enc
from ctr_recommendation_tpu_torch.tools import jax_bridge
from ctr_recommendation_tpu_torch.training import bce_with_logits
from ctr_recommendation_tpu_torch.utils.tree import tree_map
from tests.conftest import make_batch
from tests.test_torch_envelope import _tiny
from tests.test_torch_sasrec import DTYPES, _encoder_case, bf16_ulp, to_pt
from tests.test_torch_training import np_tree

torch.set_num_threads(2)

ML1M_S, ML1M_E, ML1M_L = 200, 50, 2  # SASRec's MovieLens-1M n, d and blocks


def _close(got, want, share, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=0, atol=share * np.abs(want).max(), err_msg=name)


# ------------------------------------------------------------ the streamed attention

def _attn_inputs(b, s, e, seed):
    """qkv (B*S, 3E), an additive mask with an all-pad history (row 0), a
    left-padded one whose first key tiles are all pad (row 1) and random
    pads elsewhere, and a cotangent dao."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b * s, 3 * e)).astype(np.float32)
    amask = np.where(rng.random((b, s)) < 0.3, np.float32(-1e9), np.float32(0.0))
    amask[0] = -1e9
    amask[1, :s - 3] = -1e9
    amask[1, s - 3:] = 0.0
    dao = rng.standard_normal((b * s, e)).astype(np.float32)
    return qkv, amask.astype(np.float32), dao


@pytest.mark.parametrize("d", [25, 50, 64])
@pytest.mark.parametrize("s", [33, 200, 257])
def test_streamed_attention_matches_the_jax_helpers_and_the_staged_twins(s, d):
    """attention_fwd_streamed_plain / attention_bwd_streamed_plain (keys in
    tiles of ATTN_TILE, the online softmax, P rebuilt from (m, l)) against
    the JAX kernel's _attn_fwd / _attn_bwd and the staged twins, H = 2 at
    D = 25 and 64, H = 1 at D = 50; the all-pad history's softmax uniform."""
    heads = 1 if d == 50 else 2
    e, b = heads * d, 3
    qkv, amask, dao = _attn_inputs(b, s, e, seed=s + d)
    kw = dict(tb=b, s=s, e=e, h=heads)
    out, ps = jax_enc._attn_fwd(qkv, amask[:, None, :], **kw)
    want_p = np.stack([np.asarray(t) for t in ps], axis=1)
    q, m = torch.from_numpy(qkv), torch.from_numpy(amask)
    ao_c, o, stats = eb.attention_fwd_streamed_plain(q, m, heads, torch.bfloat16)
    assert ao_c.dtype == torch.bfloat16 and torch.equal(ao_c, o.to(torch.bfloat16))
    _close(o, np.asarray(out), 2e-6, "ao")
    # P from the stats, as the backward rebuilds it
    qh, kh = (eb.heads(t, b, s, heads) for t in q.split(e, -1)[:2])
    logit = (qh.double() @ kh.double().transpose(-1, -2)).float() / d**0.5 + m[:, None, None, :]
    p = torch.exp(logit - stats[..., :1]) / stats[..., 1:]
    np.testing.assert_allclose(p.numpy(), want_p, rtol=0, atol=2e-6)
    np.testing.assert_allclose(p[0].numpy(), 1.0 / s, rtol=1e-6)  # all pad: uniform
    ao_s, p_s = eb.attention_fwd_plain(q, m, heads, torch.float32)
    _close(o, ao_s, 2e-6, "ao vs the staged twin")
    want = np.asarray(jax_enc._attn_bwd(dao, qkv, ps, **kw))
    dqkv, dqkv_c = eb.attention_bwd_streamed_plain(q, m, o, stats, torch.from_numpy(dao),
                                                   torch.bfloat16)
    _close(dqkv, want, 2e-6, "dqkv")
    assert torch.equal(dqkv_c, dqkv.to(torch.bfloat16))
    _close(dqkv, eb.attention_bwd_plain(q, p_s, torch.from_numpy(dao), torch.float32)[0], 2e-6,
           "dqkv vs the staged twin")


@pytest.mark.parametrize("s, d, route", [
    (20, 64, "staged"), (21, 64, "streamed"), (115, 64, "streamed"), (83, 128, "staged"),
    (84, 128, "streamed"), (50, 256, "staged"), (51, 256, "streamed"), (20, 32, "staged"),
    (128, 32, "streamed"), (1024, 4, "streamed")])
def test_the_attention_route(s, d, route):
    """The route the attention A/B on the card set (csrc/sasrec_encoder.cuh
    attn_staged): staged where the whole heads fit shared memory both ways
    and either the head is deeper than 64 or S is at most STAGED_S,
    streamed elsewhere; the streamed kernels' shared memory fits at every
    S and D (heads past ATTN_WHOLE deep need only their masks and stats)."""
    assert eb.attention_route(s, d) == route
    assert max(eb.attn_stream_smem(s, d)) <= eb.MAX_SMEM
    assert max(eb.attn_stream_smem(4096, 8 * d)) <= eb.MAX_SMEM


# ------------------------------------------------------------ the padded widths

@pytest.mark.parametrize("e, heads, want", [
    (128, 2, (128, 64)), (256, 4, (256, 64)), (96, 3, (96, 32)), (64, 32, (128, 4)),
    (50, 1, (64, 64)), (50, 2, (64, 32)), (48, 1, (64, 64)), (48, 2, (64, 32)),
    (48, 3, (96, 32)), (10, 2, (32, 16)), (1, 1, (32, 32)), (300, 3, (384, 128))])
def test_padded_dims(e, heads, want):
    """Each head padded to a multiple of 32 / gcd(8, H), so that the heads
    fill a stream of a multiple of 32; nothing padded at the old multiples."""
    ep, dp = enc.padded_dims(e, heads)
    assert (ep, dp) == want and ep == heads * dp and ep % 32 == 0 and dp % 4 == 0
    assert dp >= e // heads
    if e % 32 == 0 and (e // heads) % 4 == 0:
        assert (ep, dp) == (e, e // heads)


@pytest.mark.parametrize("e, heads, s", [(50, 1, 200), (50, 2, 40), (48, 2, 20), (48, 1, 150)])
def test_the_padded_path_equals_the_unpadded_plain_version(e, heads, s):
    """encode_fwd_plain / encode_bwd_plain run at the kernels' padded widths
    (padded=True: x and the weights zero-padded, LayerNorm over the true E,
    the true D's scale, dropout keyed by the true column) against the same
    functions at the true widths, dropout 0.2, L = 2: equal, the output and
    dx and every weight gradient; the staged route (S = 20) and the
    streamed one (S = 40, 150, 200)."""
    params, x, ids = _encoder_case(2, 3, seed=e + s, e=e, s=s, heads=heads)
    pp = to_pt(params)
    xm, am, pad = enc.encoder_inputs(pp, torch.from_numpy(x), torch.from_numpy(ids))
    ws = enc.stack_weights(pp, torch.float32)
    kw = dict(num_heads=heads, seed=torch.tensor([e * s], dtype=torch.int64), rate=0.2)
    assert enc.padded_dims(e, heads)[0] > e
    want = enc.encode_fwd_plain(xm, am, *ws, **kw)
    assert torch.equal(enc.encode_fwd_plain(xm, am, *ws, **kw, padded=True), want)
    assert not torch.equal(want, enc.encode_fwd_plain(xm, am, *ws, num_heads=heads))  # drops
    g = torch.from_numpy(np.random.default_rng(s).standard_normal(xm.shape).astype(np.float32))
    g = g * ~pad[..., None]
    got_b = enc.encode_bwd_plain(g, xm, am, *ws, **kw, padded=True)
    for name, a, w in zip(("dx",) + enc.WEIGHT_NAMES, got_b,
                          enc.encode_bwd_plain(g, xm, am, *ws, **kw)):
        assert a.shape == w.shape and torch.equal(a, w), name


def test_pad_weights_round_trips_and_keeps_the_heads_apart():
    """pad_weights then unpad_grads gives each weight back; q, k and v keep
    head i's D columns at i Dp of their segment, the rest zero."""
    params, _, _ = _encoder_case(2, 2, e=50, s=8, heads=2)
    ws = enc.stack_weights(to_pt(params), torch.float32)
    wp = enc.pad_weights(ws, 50, 2)
    assert wp[0].shape == (2, 64, 192) and wp[6].shape == (2, 64, 256)
    for a, w in zip(enc.unpad_grads(wp, 50, 2), ws):
        assert torch.equal(a, w)
    qkv_w = wp[0][0]
    for seg in range(3):
        for hh in range(2):
            c0 = seg * 64 + hh * 32
            assert torch.equal(qkv_w[:50, c0:c0 + 25], ws[0][0][:, seg * 50 + hh * 25:][:, :25])
            assert not qkv_w[:, c0 + 25:c0 + 32].any() and not qkv_w[50:].any()


def test_dropout_keys_a_column_whatever_the_width():
    """dropout_mask at a width off a multiple of 4 is the first columns of
    the mask at any wider width: the padded kernels draw the true masks."""
    seed = torch.tensor([77], dtype=torch.int64)
    wide = eb.dropout_mask(seed, 40, 64, 1, 0, 0.2)
    for e in (1, 25, 50, 63):
        assert torch.equal(eb.dropout_mask(seed, 40, e, 1, 0, 0.2), wide[:, :e])


# ------------------------------------------------------------ fused_encode against JAX

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [1, 2])
def test_fused_encode_at_the_ml1m_shape_matches_the_jax_kernel(heads, dtype):
    """S = 200, E = 50, L = 2, B = 4: the port's fused_encode (its plain
    version on CPU tensors: the streamed attention at the padded widths'
    route) against the JAX kernel in interpret mode."""
    assert enc.fits(ML1M_S, ML1M_E, heads, ML1M_L)
    assert eb.attention_route(ML1M_S, enc.padded_dims(ML1M_E, heads)[1]) == "streamed"
    params, x, ids = _encoder_case(ML1M_L, 4, seed=heads, e=ML1M_E, s=ML1M_S, heads=heads)
    jd, td = DTYPES[dtype]
    want = np.asarray(jax_enc.fused_encode(params, jnp.asarray(x).astype(jd), jnp.asarray(ids),
                                           num_heads=heads, block_b=8), np.float32)
    launches = enc.encode_fwd.launches
    got = enc.fused_encode(to_pt(params), torch.from_numpy(x).to(td), torch.from_numpy(ids),
                           num_heads=heads)
    assert enc.encode_fwd.launches == launches  # a CPU tensor takes the plain version
    assert got.dtype == td and got.shape == (4, ML1M_S, ML1M_E) and not got[0].any()
    atol = 3e-6 if dtype == "float32" else bf16_ulp(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [1, 2])
def test_encode_bwd_at_the_ml1m_shape_matches_the_jax_vjp(heads, dtype):
    """dx and the 12 weight gradients of encode_bwd (its plain version here)
    against jax.vjp of the JAX kernel's _fused at S = 200, E = 50, L = 2."""
    b, s, e, layers = 4, ML1M_S, ML1M_E, ML1M_L
    params, x, ids = _encoder_case(layers, b, seed=10 + heads, e=e, s=s, heads=heads)
    jd, td = DTYPES[dtype]
    pp = to_pt(params)
    xm, am, pad = enc.encoder_inputs(pp, torch.from_numpy(x).to(td), torch.from_numpy(ids))
    g = np.random.default_rng(heads).standard_normal((b, s, e)).astype(np.float32)
    g = torch.from_numpy(g * ~pad.numpy()[..., None]).to(td)
    ws = enc.stack_weights(pp, torch.float32)

    def f(xx, w):
        return jax_enc._fused(xx, jnp.asarray(am.numpy()), jnp.zeros((1,), jnp.float32), w,
                              s, e, heads, layers, 0.0, True, 8)

    jx = jnp.asarray(xm.float().numpy().reshape(b, s * e)).astype(jd)
    _, vjp = jax.vjp(f, jx, tuple(jnp.asarray(w.numpy()) for w in ws))
    dx, dws = vjp(jnp.asarray(g.float().numpy().reshape(b, s * e)).astype(jd))
    want = [np.asarray(dx, np.float32).reshape(b, s, e)] + [np.asarray(t) for t in dws]
    wd = enc.cast_matrices(ws, td)
    got = enc.encode_bwd(g, xm, am, *wd, num_heads=heads)
    if dtype == "bfloat16":  # the rounding cascade through two layers
        f32 = enc.encode_bwd(g.float(), xm.float(), am, *enc.cast_matrices(wd, torch.float32),
                             num_heads=heads)
        for name, a, w, r in zip(("dx",) + enc.WEIGHT_NAMES, got, want, f32):
            a = a.float().numpy()
            assert np.isfinite(a).all(), name
            assert np.linalg.norm(a - w) <= 0.5 * np.linalg.norm(a - r.numpy()), name
        return
    for name, a, w in zip(("dx",) + enc.WEIGHT_NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(w).max()), err_msg=name)


# ------------------------------------------------------------ the model at the ML-1M shape

def _ml1m(tiny_experiment, heads):
    """The tiny experiment at SASRec's ML-1M shape: max_len 200, E = 50,
    two blocks and ``heads`` heads, fp32, use_pallas on."""
    exp, fm, module, params, state, pexp, pfm, pparams, pstate = _tiny(
        tiny_experiment, e=ML1M_E, max_len=ML1M_S, model="sasrec_fibinet", layers=ML1M_L,
        heads=heads)
    return exp, fm, module, params, state, pexp, pfm, pparams, pstate


@pytest.mark.parametrize("heads", [1, 2])
def test_sasrec_predictor_at_the_ml1m_shape_matches_jax(tiny_experiment, heads):
    """sasrec_fibinet served at max_len 200, E = 50, L = 2: the JAX
    Predictor runs its Pallas encoder and scoring kernels in interpret
    mode; the port's runs its kernels' plain versions, the encoder at the
    padded widths' streamed route."""
    exp, _, _, params, state, pexp, _, pparams, pstate = _ml1m(tiny_experiment, heads)
    batch = make_batch(np.random.default_rng(heads), 12, max_len=ML1M_S)
    batch["item_seq"][0] = 0  # an all-pad history
    mm = np.zeros((200, 24), np.float32)
    mm[batch["item_id"]] = batch["item_emb_d128"]
    store = ItemStore.from_arrays(np.arange(200), mm)
    want = np.asarray(JaxPredictor(exp, params, state,
                                   item_store=JaxItemStore(store.emb, store.known_mask))(batch))
    pred = Predictor(pexp, pparams, pstate, device="cpu", item_store=store)
    assert pred.use_fused
    np.testing.assert_allclose(pred(batch).numpy(), want, rtol=1e-4, atol=1e-5)


def test_sasrec_train_step_at_the_ml1m_shape_matches_jax(tiny_experiment):
    """One sasrec_fibinet train step at max_len 200, E = 50, one head, L =
    2, fp32, dropout off, use_pallas on both sides (the JAX kernels in
    interpret mode, the port's plain versions): the loss and every
    parameter gradient."""
    exp, fm, module, params, state, pexp, pfm, pparams, pstate = _ml1m(tiny_experiment, 1)
    cfg = dataclasses.replace(exp.model, attn_dropout=0.0, net_dropout=0.0)
    pcfg = dataclasses.replace(pexp.model, attn_dropout=0.0, net_dropout=0.0)
    rng = np.random.default_rng(5)
    batch = make_batch(rng, 16, max_len=ML1M_S)
    batch["item_seq"][0] = 0
    labels = (rng.random(16) < 0.4).astype(np.float32)
    weight = np.ones(16, np.float32)

    def loss_fn(p):
        logits, new_state = module.apply(
            p, state, fm, cfg, batch, train=True, rng=jax.random.key(9),
            compute_dtype=jnp.float32, weight=jnp.asarray(weight))
        return jax_bce(logits, jnp.asarray(labels), jnp.asarray(weight)), new_state

    (want_loss, _), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    leaves = list(jax_bridge.flatten(tree_map(lambda t: t.requires_grad_(), pparams)).values())
    logits, _ = get_model("sasrec_fibinet").apply(
        pparams, pstate, pfm, pcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        train=True, generator=torch.Generator().manual_seed(3), compute_dtype=torch.float32,
        weight=torch.from_numpy(weight))
    loss = bce_with_logits(logits, torch.from_numpy(labels), torch.from_numpy(weight))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    flat_want = jax_bridge.flatten(np_tree(want_grads))
    flat_got = jax_bridge.flatten(pparams)
    assert "trunk/attn/item_seq/blocks/1/qkv/w" in flat_got
    for path, g in zip(flat_got, grads):
        w = flat_want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=path)
