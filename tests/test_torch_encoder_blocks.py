"""The SASRec encoder's building blocks (ops/cuda/encoder_blocks.py) and the
encoder at E=256 against the JAX package.

The blocks' kernels cannot run without a card; their plain versions, which
``encode_fwd_plain`` and ``encode_bwd_plain`` are composed of, are held
here against the JAX kernel's own helpers (``_ln_fwd``, ``_ln_bwd``,
``_attn_fwd``, ``_attn_bwd`` of ops/pallas/sasrec_encoder.py) and against
numpy in fp64. The encoder itself at E=256 (the kernels' envelope reaches
it) goes through ``fused_encode`` and ``encode_bwd`` on the CPU against the
JAX ``fused_encode`` and ``jax.vjp`` of ``_fused`` in Pallas interpret mode.
Tests marked ``cuda`` hold each block's kernel, and the wrappers at E=256,
against the plain versions on the card at chip_smoke.py's bars.

Tolerances, each with its reason:
- LayerNorm, attention and their backwards: fp32 2e-6 of the output's
  largest magnitude (the same fp32 operations, summed in another order).
- products: against numpy fp64 products of the same operands rounded to
  fp32 (the plain version accumulates in fp64): 1e-6 relative.
- the encoder at E=256: the bars of tests/test_torch_sasrec.py (forward:
  fp32 3e-6, bf16 one bf16 ulp of the largest magnitude) and of
  tests/test_torch_sasrec_training.py (backward: fp32 2e-6 of each output's
  largest magnitude; bf16 2^-8 of it and 2^-12 in norm), but for the bf16
  backward at L=2 (see that test: a rounding cascade through two layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.ops.pallas import sasrec_encoder as jax_enc
from ctr_recommendation_tpu_torch.ops.cuda import encoder_blocks as eb
from ctr_recommendation_tpu_torch.ops.cuda import sasrec_encoder as enc
from tests.test_torch_sasrec import DTYPES, _encoder_case, bf16_ulp, to_pt

torch.set_num_threads(2)

WIDE_S = 20  # sasrec_fibinet's max_len


def _close(got, want, share, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=0, atol=share * np.abs(want).max(), err_msg=name)


def _attn_inputs(b, s, e, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b * s, 3 * e)).astype(np.float32)
    amask = np.where(rng.random((b, s)) < 0.3, np.float32(-1e9), np.float32(0.0))
    amask[0] = -1e9  # an all-pad history: a uniform softmax
    return qkv, amask


# ------------------------------------------------------------ the plain blocks


@pytest.mark.parametrize("e", [32, 256])
def test_layer_norm_matches_the_jax_kernels_helper(e):
    rng = np.random.default_rng(e)
    h = (rng.standard_normal((96, e)) * 3 + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(e).astype(np.float32) for _ in range(2))
    out, xhat, r = (np.array(t) for t in jax_enc._ln_fwd(h, scale, bias))
    for dt in (torch.float32, torch.bfloat16):
        hn, xh, rs = eb.layer_norm_plain(torch.from_numpy(h), torch.from_numpy(scale),
                                         torch.from_numpy(bias), dt, residues=True)
        assert hn.dtype == dt
        want = torch.from_numpy(out).to(dt).float().numpy()
        share = 2e-6 if dt == torch.float32 else bf16_ulp(want) / np.abs(want).max()
        _close(hn.float(), want, share)
        _close(xh, xhat, 2e-6, "xhat")
        _close(rs, r[:, 0], 2e-6, "rstd")


@pytest.mark.parametrize("e", [32, 256])
def test_layer_norm_backward_and_its_sums_match_the_jax_kernels_helper(e):
    rng = np.random.default_rng(e + 1)
    h = rng.standard_normal((96, e)).astype(np.float32)
    g = rng.standard_normal((96, e)).astype(np.float32)
    scale = rng.standard_normal(e).astype(np.float32)
    _, xhat, r = jax_enc._ln_fwd(h, scale, np.zeros(e, np.float32))
    dx, dscale, dbias = (np.asarray(t) for t in jax_enc._ln_bwd(g, xhat, r, scale))
    xt, rt = torch.from_numpy(np.array(xhat)), torch.from_numpy(np.array(r)[:, 0])
    dh = torch.from_numpy(rng.standard_normal((96, e)).astype(np.float32))
    got = eb.layer_norm_bwd_plain(torch.from_numpy(g), xt, rt, torch.from_numpy(scale), dh)
    _close(got - dh, dx, 2e-6, "dx")
    ds, db = eb.column_sums_plain(torch.from_numpy(g), "ln", x=xt, chunk=32)
    _close(eb.reduce_partials_plain(ds), dscale, 2e-6, "dscale")
    _close(eb.reduce_partials_plain(db), dbias, 2e-6, "dbias")


@pytest.mark.parametrize("e,heads", [(32, 2), (256, 2), (256, 4)])
def test_attention_matches_the_jax_kernels_helpers(e, heads):
    b, s = 3, WIDE_S
    qkv, amask = _attn_inputs(b, s, e, seed=e + heads)
    kw = dict(tb=b, s=s, e=e, h=heads)
    out, ps = jax_enc._attn_fwd(qkv, amask[:, None, :], **kw)
    ao, p = eb.attention_fwd_plain(torch.from_numpy(qkv), torch.from_numpy(amask), heads,
                                   torch.float32)
    _close(ao, np.asarray(out), 2e-6, "ao")
    _close(p, np.stack([np.asarray(t) for t in ps], axis=1), 2e-6, "p")
    dao = np.random.default_rng(e).standard_normal((b * s, e)).astype(np.float32)
    want = np.asarray(jax_enc._attn_bwd(dao, qkv, ps, **kw))
    dqkv, dqkv_c = eb.attention_bwd_plain(torch.from_numpy(qkv), p, torch.from_numpy(dao),
                                          torch.bfloat16)
    _close(dqkv, want, 2e-6, "dqkv")
    assert dqkv_c.dtype == torch.bfloat16 and torch.equal(dqkv_c, dqkv.to(torch.bfloat16))


@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
def test_product_layouts_and_epilogues_against_numpy(layout):
    rng = np.random.default_rng(len(layout))
    m, n, k = 70, 96, 64
    a = rng.standard_normal((k, m) if layout == "tn" else (m, k)).astype(np.float32)
    b = rng.standard_normal((n, k) if layout == "nt" else (k, n)).astype(np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    c = a64 @ b64 if layout == "nn" else a64 @ b64.T if layout == "nt" else a64.T @ b64
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    _close(eb.product_plain(at, bt, layout), c.astype(np.float32), 1e-6)
    bias = rng.standard_normal(n).astype(np.float32)
    _close(eb.product_plain(at, bt, layout, "bias", bias=torch.from_numpy(bias)),
           c.astype(np.float32) + bias, 1e-6)
    relu = eb.product_plain(at, bt, layout, "relu", bias=torch.from_numpy(bias),
                            out_dtype=torch.bfloat16)
    assert relu.dtype == torch.bfloat16
    assert torch.equal(relu, torch.relu(torch.from_numpy(c.astype(np.float32) + bias))
                       .to(torch.bfloat16))
    aux = rng.standard_normal((m, n)).astype(np.float32)
    seed = torch.tensor([7], dtype=torch.int64)
    res = eb.product_plain(at, bt, layout, "residual", bias=torch.from_numpy(bias),
                           aux=torch.from_numpy(aux), seed=seed, rate=0.25, layer=1, branch=0)
    keep = eb.dropout_mask(seed, m, n, 1, 0, 0.25).numpy()
    dropped = np.where(keep, (c.astype(np.float32) + bias) * np.float32(1 / 0.75), 0)
    _close(res, aux + dropped, 1e-6)
    gate = np.where(rng.random((m, n)) < 0.5, 0.0, 1.0).astype(np.float32)
    y, yc = eb.product_plain(at.to(torch.bfloat16), bt.to(torch.bfloat16), layout, "gate",
                             aux=torch.from_numpy(gate).to(torch.bfloat16))
    ab, bb = at.to(torch.bfloat16).double().numpy(), bt.to(torch.bfloat16).double().numpy()
    cb = ab @ bb if layout == "nn" else ab @ bb.T if layout == "nt" else ab.T @ bb
    _close(y, (cb * gate).astype(np.float32), 1e-6)
    assert yc.dtype == torch.bfloat16 and torch.equal(yc, y.to(torch.bfloat16))
    if layout == "tn":  # the chunked partials sum to the whole product
        part = eb.product_plain(at, bt, "tn", "partial", chunk=32)
        assert part.shape == (2, m, n)
        _close(eb.reduce_partials_plain(part), c.astype(np.float32), 1e-6)


def test_column_sums_modes_and_chunks():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((100, 64)).astype(np.float32)
    x = rng.standard_normal((100, 64)).astype(np.float32)
    gt, xt = torch.from_numpy(g), torch.from_numpy(x)
    part = eb.column_sums_plain(gt, chunk=32)
    assert part.shape == (4, 64)
    _close(part[3], g[96:].sum(0), 1e-6)
    _close(eb.reduce_partials_plain(part), g.astype(np.float64).sum(0), 1e-6)
    s1, s2 = eb.column_sums_plain(gt, "ln", x=xt)
    _close(s1[0], (g.astype(np.float64) * x).sum(0), 1e-6)
    _close(s2[0], g.astype(np.float64).sum(0), 1e-6)
    seed = torch.tensor([11], dtype=torch.int64)
    sums, gated = eb.column_sums_plain(gt, "gate", seed=seed, rate=0.1, layer=0, branch=1,
                                       cd=torch.bfloat16, chunk=64)
    v = eb.dropout(gt, seed, 0, 1, 0.1)
    assert gated.dtype == torch.bfloat16 and torch.equal(gated, v.to(torch.bfloat16))
    assert (v == 0).float().mean().item() > 0.05  # the gate drops
    _close(eb.reduce_partials_plain(sums), v.double().sum(0).numpy(), 1e-6)


def test_launch_counts_are_a_function_of_the_depth():
    assert [enc.fwd_launches(n) for n in (1, 2)] == [8, 15]
    assert [enc.bwd_launches(n) for n in (1, 2)] == [26, 51]


def test_the_wrappers_refuse_outside_the_envelope():
    params, x, ids = _encoder_case(1, 2, e=32, s=WIDE_S, heads=2)
    pp = to_pt(params)
    xm, am, _ = enc.encoder_inputs(pp, torch.from_numpy(x), torch.from_numpy(ids))
    ws = enc.stack_weights(pp, torch.float32)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        eb.product(xm.reshape(-1, 32).to("meta"), ws[0][0].to("meta"), "nn", "bias")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        eb.layer_norm(xm.reshape(-1, 32).to("meta"), ws[4][0], ws[5][0], torch.float32)
    enc.check_envelope(WIDE_S, 256, 2, 1)
    enc.check_envelope(32, 512, 2, 3)
    enc.check_envelope(50, 128, 2, 1)  # SASRec's published n = 50
    enc.check_envelope(128, 64, 4, 1)
    # past the staged attention's shared memory, off the old multiples and
    # heads wider than 256 (the streamed attention's chunks): taken
    for s, e, heads, layers in ((129, 64, 4, 1), (200, 128, 2, 1), (116, 64, 1, 1),
                                (84, 128, 1, 1), (20, 48, 2, 1), (20, 64, 32, 1),
                                (200, 50, 1, 2), (20, 288, 1, 1), (20, 512, 1, 1),
                                (200, 1024, 1, 2)):
        enc.check_envelope(s, e, heads, layers)
    enc.check_envelope(enc.MAX_STREAM_S, 32, 1, 1)
    assert enc.fits(enc.MAX_STREAM_S + 1, 32, 1, 1)  # fits has no S bound: the call's grid has
    # any batch: a call of MAX_TOKENS + 1 tokens (19 x 441,499) is taken, in two chunks of rows
    b, s = 441_499, 19
    assert b * s == enc.MAX_TOKENS + 1
    enc.check_envelope(s, 32, 2, 1)
    plan = enc.plan_chunks(b, s, 32, 2, 1, torch.bfloat16, "fwd")
    assert plan == ((0, b - 1), (b - 1, b)) and (b - 1) * s <= enc.MAX_TOKENS
    for s, e, heads, layers in ((20, 288, 5, 1), (20, 128, 3, 1), (20, 128, 2, 0), (0, 128, 2, 1),
                                (enc.MAX_STREAM_S + 1, 32, 1, 1)):
        with pytest.raises(ValueError, match="envelope"):
            enc.check_envelope(s, e, heads, layers)


# ------------------------------------------------------------ the encoder at E=256

WIDE_CASES = [(256, 2, 1), (256, 4, 1), (256, 2, 2), (256, 4, 2)]  # (E, H, L)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,heads,layers", WIDE_CASES)
def test_fused_encode_at_e256_matches_the_jax_kernel(e, heads, layers, dtype):
    b = 6
    params, x, ids = _encoder_case(layers, b, seed=heads + layers, e=e, s=WIDE_S, heads=heads)
    jd, td = DTYPES[dtype]
    want = np.asarray(
        jax_enc.fused_encode(params, jnp.asarray(x).astype(jd), jnp.asarray(ids),
                             num_heads=heads, block_b=8),
        np.float32,
    )
    launches = enc.encode_fwd.launches
    got = enc.fused_encode(to_pt(params), torch.from_numpy(x).to(td), torch.from_numpy(ids),
                           num_heads=heads)
    assert enc.encode_fwd.launches == launches  # a CPU tensor takes the plain version
    assert got.dtype == td and got.shape == (b, WIDE_S, e)
    atol = 3e-6 if dtype == "float32" else bf16_ulp(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    assert (got[torch.from_numpy(ids == 0)] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,heads,layers", WIDE_CASES)
def test_encode_bwd_at_e256_matches_the_jax_vjp(e, heads, layers, dtype):
    b, s = 6, WIDE_S
    params, x, ids = _encoder_case(layers, b, seed=10 + heads + layers, e=e, s=s, heads=heads)
    jd, td = DTYPES[dtype]
    pp = to_pt(params)
    xm, am, pad = enc.encoder_inputs(pp, torch.from_numpy(x).to(td), torch.from_numpy(ids))
    g = np.random.default_rng(layers).standard_normal((b, s, e)).astype(np.float32)
    g = torch.from_numpy(g * ~pad.numpy()[..., None]).to(td)
    ws = enc.stack_weights(pp, torch.float32)

    def f(xx, w):
        return jax_enc._fused(xx, jnp.asarray(am.numpy()), jnp.zeros((1,), jnp.float32), w,
                              s, e, heads, layers, 0.0, True, 8)

    jx = jnp.asarray(xm.float().numpy().reshape(b, s * e)).astype(jd)
    _, vjp = jax.vjp(f, jx, tuple(jnp.asarray(w.numpy()) for w in ws))
    dx, dws = vjp(jnp.asarray(g.float().numpy().reshape(b, s * e)).astype(jd))
    want = [np.asarray(dx, np.float32).reshape(b, s, e)] + [np.asarray(t) for t in dws]
    launches = enc.encode_bwd.launches
    wd = enc.cast_matrices(ws, td)
    got = enc.encode_bwd(g, xm, am, *wd, num_heads=heads)
    assert enc.encode_bwd.launches == launches
    if dtype == "bfloat16" and layers == 2:
        # the rounding cascade: each side's own fp32 sums round some cd
        # operands of layer 0 a bf16 ulp apart, which moves every value
        # layer 1 computes and flips ReLU gates there (1e-3 to 9e-3 in norm
        # at E=256, against 1e-7 at E=64). The bar: the two bf16 backwards
        # lie at most half as far apart as the port's bf16 backward lies
        # from its fp32 backward on the same values (0.03-0.36 measured).
        f32 = enc.encode_bwd(g.float(), xm.float(), am, *enc.cast_matrices(wd, torch.float32),
                             num_heads=heads)
        for name, a, w, r in zip(("dx",) + enc.WEIGHT_NAMES, got, want, f32):
            a = a.float().numpy()
            assert np.isfinite(a).all(), name
            assert np.linalg.norm(a - w) <= 0.5 * np.linalg.norm(a - r.numpy()), name
        return
    share = 2e-6 if dtype == "float32" else 2.0**-8
    for name, a, w in zip(("dx",) + enc.WEIGHT_NAMES, got, want):
        a = a.float().numpy()
        _close(a, w, share, name)
        if dtype == "bfloat16":
            assert np.linalg.norm(a - w) <= 2.0**-12 * np.linalg.norm(w), name


# ------------------------------------------------------- on the card only


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,heads", [(128, 2), (256, 2)])
def test_each_block_kernel_matches_its_plain_version_on_the_card(e, heads, dtype):
    """chip_smoke.py's phase-2 block checks at full width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the block kernels have no CPU mode")
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    _, failures = chip_smoke.encoder_blocks_against_plain(torch, e, heads, DTYPES[dtype][1])
    assert not failures


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_wrappers_at_e256_match_plain_on_the_card(dtype, rate):
    """encode_fwd and encode_bwd at E=256, H=2, L=1, B=4133 against their
    plain versions at chip_smoke.py's bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the encoder kernels have no CPU mode")
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    td = DTYPES[dtype][1]
    b, e = 4133, 256
    x, amask, pad, ws, _, _, _ = chip_smoke.encoder_case(torch, td, b, e, 2, 1, seed=b)
    seed = torch.tensor([b], dtype=torch.int64, device="cuda")
    kw = dict(num_heads=2, seed=seed, rate=rate)
    got = enc.encode_fwd(x, amask, *ws, **kw)
    assert chip_smoke.check_encoder(torch, got, enc.encode_fwd_plain(x, amask, *ws, **kw),
                                    dtype)[2]
    g = chip_smoke.encoder_cotangent(torch, pad, e, b, td)
    grads = enc.encode_bwd(g, x, amask, *ws, **kw)
    assert not chip_smoke.check_encoder_bwd(torch, grads,
                                            enc.encode_bwd_plain(g, x, amask, *ws, **kw),
                                            dtype)[3]
