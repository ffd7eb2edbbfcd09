"""The streamed attention's 3xTF32 arithmetic and its widest heads (CPU).

The streamed attention kernels (csrc/sasrec_encoder.cuh
``attention_fwd_streamed`` / ``attention_bwd_streamed``) run their products
on the tensor cores in TF32: each fp32 operand x splits into hi = tf32(x)
and lo = tf32(x - hi), a product is hi lo + lo hi + hi hi, and each k-step
of eight sums into a fresh fp32 fragment that is then added to the running
sum. The kernels cannot run here; ``emulated_fwd`` / ``emulated_bwd`` run
the same arithmetic in PyTorch, in the kernels' tile order (keys and, for
dk and dv, queries in tiles of ATTN_TILE; k-steps of 8; the online softmax
with exp2), TF32 rounded by bit mask as the kernels round it (to nearest on
the top 19 bits, ties away from zero: cvt.rna.tf32.f32's rounding). Each
k-step's three products are summed exactly and rounded once to fp32, where
the tensor core truncates.

Held, at each attention shape of chip_smoke.py's LONG_CASES and at head
widths 288 and 512 (B = 2, one all-pad history and one left-padded):
- the emulation against the fp64 plain versions
  (``attention_fwd_streamed_plain`` / ``attention_bwd_streamed_plain``)
  within ENC_TOL["float32"] of chip_smoke.py as it stands, o, m (on the
  histories with a real key), l and dqkv: the bar the kernels' outputs
  are held to on the card;
- single-pass TF32 (hi hi alone) as a control that misses that bar in every
  case.

Then the widest heads against the JAX package:
- the streamed plain versions at D = 288 and 512 against the JAX kernel's
  ``_attn_fwd`` / ``_attn_bwd`` (2e-6 of the output's largest magnitude:
  the same fp32 operations summed in another order);
- ``fused_encode`` at E = 512 with one head, S = 20 (the staged route) and
  40 (the streamed one), forward and every gradient, against the JAX
  kernel in interpret mode at the bars tests/test_torch_encoder_blocks.py
  holds E = 256 to (forward fp32 3e-6, bf16 one bf16 ulp of the largest
  magnitude; gradients fp32 2e-6 of the largest, bf16 2^-8 of it and 2^-12
  in norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_BLOCK_SHAPES, ENC_TOL, LONG_CASES
from ctr_recommendation_tpu.ops.pallas import sasrec_encoder as jax_enc
from ctr_recommendation_tpu_torch.ops.cuda import encoder_blocks as eb
from ctr_recommendation_tpu_torch.ops.cuda import sasrec_encoder as enc
from tests.test_torch_encoder_blocks import _close
from tests.test_torch_sasrec import DTYPES, _encoder_case, bf16_ulp, to_pt

torch.set_num_threads(2)

LOG2E = 1.4426950408889634
# the attention shapes (S, E, H) of LONG_CASES, and heads of 288 and 512
SHAPES = list(dict.fromkeys([c[:3] for c in LONG_CASES] + [(50, 288, 1), (20, 512, 1)]))


def tf32(x):
    """x rounded to TF32 as the kernels round it: (bits + 0x1000) with the
    low 13 bits cleared."""
    u = x.float().contiguous().view(torch.int32)
    return ((u + 0x1000) & -8192).view(torch.float32)


def mm_tf32(a, b, single=False):
    """a (..., M, K) . b (..., N, K) -> (..., M, N) fp32 as the kernels sum
    it: per k-step of 8, hi lo + lo hi + hi hi (hi hi alone with
    ``single``) summed exactly and rounded once, then added to the fp32
    sum in k order."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    acc = torch.zeros(a.shape[:-1] + b.shape[-2:-1], dtype=torch.float32)
    for k in range(0, a.shape[-1], 8):
        sl = slice(k, k + 8)
        part = ah[..., sl].double() @ bh[..., sl].double().transpose(-1, -2)
        if not single:
            part = (part + ah[..., sl].double() @ bl[..., sl].double().transpose(-1, -2)
                    + al[..., sl].double() @ bh[..., sl].double().transpose(-1, -2))
        acc = acc + part.float()
    return acc


def _exp(x):
    """The kernels' exp: exp2 of x log2(e), both in fp32."""
    return torch.exp2(x * LOG2E)


def _logits(s, scale, mask):
    """fma(s, scale, mask): one rounding, as __fmaf_rn."""
    return (s.double() * scale + mask.double()).float()


def emulated_fwd(qkv, amask, heads, scale, single=False):
    """The forward kernel's arithmetic: (o (B*S, E), m (B, H, S), l)."""
    b, s = amask.shape
    e = qkv.shape[1] // 3
    q, k, v = (eb.heads(t, b, s, heads) for t in qkv.split(e, -1))
    mask = amask[:, None, None, :]
    m = torch.full(q.shape[:3], -3.0e38)
    l = torch.zeros(q.shape[:3])
    o = torch.zeros(q.shape)
    for j0 in range(0, s, eb.ATTN_TILE):
        j1 = min(s, j0 + eb.ATTN_TILE)
        logit = _logits(mm_tf32(q, k[:, :, j0:j1], single), scale, mask[..., j0:j1])
        mn = torch.maximum(m, logit.amax(-1))
        alpha = _exp(m - mn)
        p = _exp(logit - mn[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm_tf32(p, v[:, :, j0:j1].transpose(-1, -2), single)
        m = mn
    return eb.merge(o / l[..., None]), m, l


def emulated_bwd(qkv, amask, o, stats, dao, scale, single=False):
    """The backward kernel's arithmetic, from the forward's o and stats:
    dqkv (B*S, 3E); dq over the key tiles (the query half), dk and dv over
    the query tiles (the key half)."""
    b, h, s, _ = stats.shape
    e = dao.shape[1]
    g = eb.heads(dao, b, s, h)
    q, k, v = (eb.heads(t, b, s, h) for t in qkv.split(e, -1))
    di = (g * eb.heads(o, b, s, h)).sum(-1)
    m, il = stats[..., 0], 1.0 / stats[..., 1]
    mask = amask[:, None, None, :]
    dq = torch.zeros(q.shape)
    for j0 in range(0, s, eb.ATTN_TILE):
        j1 = min(s, j0 + eb.ATTN_TILE)
        kt, vt = k[:, :, j0:j1], v[:, :, j0:j1]
        p = _exp(_logits(mm_tf32(q, kt, single), scale, mask[..., j0:j1]) - m[..., None])
        ds = p * il[..., None] * (mm_tf32(g, vt, single) - di[..., None]) * scale
        dq = dq + mm_tf32(ds, kt.transpose(-1, -2), single)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    key_mask = amask[:, None, :, None]
    for i0 in range(0, s, eb.ATTN_TILE):
        i1 = min(s, i0 + eb.ATTN_TILE)
        qt, gt = q[:, :, i0:i1], g[:, :, i0:i1]
        pt = _exp(_logits(mm_tf32(k, qt, single), scale, key_mask) - m[:, :, None, i0:i1])
        pt = pt * il[:, :, None, i0:i1]
        dst = pt * (mm_tf32(v, gt, single) - di[:, :, None, i0:i1]) * scale
        dv = dv + mm_tf32(pt, gt.transpose(-1, -2), single)
        dk = dk + mm_tf32(dst, qt.transpose(-1, -2), single)
    return torch.cat([eb.merge(dq), eb.merge(dk), eb.merge(dv)], dim=-1)


def _inputs(s, e, heads, seed, b=2):
    """qkv at the kernels' padded widths (the padded columns zero), an
    all-pad history (row 0), a left-padded one (row 1), random pads past
    it, and a cotangent; the true D's scale."""
    ep, dp = enc.padded_dims(e, heads)
    d = e // heads
    rng = np.random.default_rng(seed)
    qkv = np.zeros((b * s, 3, heads, dp), np.float32)
    qkv[..., :d] = rng.standard_normal((b * s, 3, heads, d))
    dao = np.zeros((b * s, heads, dp), np.float32)
    dao[..., :d] = rng.standard_normal((b * s, heads, d))
    amask = np.where(rng.random((b, s)) < 0.3, -1e9, 0.0).astype(np.float32)
    amask[0] = -1e9
    amask[1, :s - 3] = -1e9
    amask[1, s - 3:] = 0.0
    return (torch.from_numpy(qkv.reshape(b * s, 3 * ep)), torch.from_numpy(amask),
            torch.from_numpy(dao.reshape(b * s, ep)), 1.0 / d**0.5)


def _within(got, want) -> bool:
    """chip_smoke.py's fp32 bar: |d| <= share max|want| + rtol |want|."""
    share, rtol = ENC_TOL["float32"]
    got, want = got.double(), want.double()
    return bool(((got - want).abs() <= share * want.abs().max() + rtol * want.abs()).all())


def _held(s, e, heads, single):
    """{output: within the bar} of the emulated kernels against the plain
    versions at (S, E, H)."""
    qkv, amask, dao, scale = _inputs(s, e, heads, seed=s + e + heads)
    _, o_w, st_w = eb.attention_fwd_streamed_plain(qkv, amask, heads, torch.float32, scale=scale)
    o, m, l = emulated_fwd(qkv, amask, heads, scale, single)
    real = ~(amask <= -1e8).all(-1)
    want_b, _ = eb.attention_bwd_streamed_plain(qkv, amask, o_w, st_w, dao, torch.float32,
                                                scale=scale)
    got_b = emulated_bwd(qkv, amask, o_w, st_w, dao, scale, single)
    assert torch.isfinite(got_b).all() and torch.isfinite(o).all()
    return {"o": _within(o, o_w), "m": _within(m[real], st_w[..., 0][real]),
            "l": _within(l, st_w[..., 1]), "dqkv": _within(got_b, want_b)}


def test_the_shapes_cover_long_cases_and_the_wide_heads():
    assert {c[:3] for c in LONG_CASES} <= set(SHAPES)
    assert {(50, 288, 1), (20, 512, 1)} <= set(SHAPES) and (20, 512, 1) in ATTN_BLOCK_SHAPES


@pytest.mark.parametrize("s, e, heads", SHAPES)
def test_3xtf32_holds_the_fp32_bar(s, e, heads):
    """The kernels' 3xTF32 arithmetic within ENC_TOL["float32"] of the fp64
    plain versions: o, m, l and dqkv."""
    held = _held(s, e, heads, single=False)
    assert all(held.values()), held


@pytest.mark.parametrize("s, e, heads", SHAPES)
def test_single_pass_tf32_misses_the_fp32_bar(s, e, heads):
    """The control: hi hi alone (one TF32 product) falls outside the bar."""
    held = _held(s, e, heads, single=True)
    assert not all(held.values()), held


def test_tf32_rounds_to_nearest_ties_away():
    """tf32 keeps 10 mantissa bits, rounding to nearest with ties away from
    zero (cvt.rna); hi + lo is x to within 2^-22 of it."""
    one_ulp = 2.0**-10
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4,
                      1.0 + 3 * one_ulp / 4, -(1.0 + one_ulp / 4)])
    want = torch.tensor([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + one_ulp, -1.0])
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi = tf32(y)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert ((hi - y).abs() <= 2.0**-11 * y.abs()).all()
    assert ((hi + tf32(y - hi) - y).abs() <= 2.0**-22 * y.abs()).all()


# ------------------------------------------------- the widest heads against JAX

@pytest.mark.parametrize("s, d", [(33, 288), (70, 512)])
def test_streamed_plain_versions_at_wide_heads_match_the_jax_helpers(s, d):
    """attention_fwd_streamed_plain / attention_bwd_streamed_plain at one
    head of 288 and of 512 against the JAX kernel's _attn_fwd / _attn_bwd
    (an all-pad history among three)."""
    b = 3
    qkv, amask, dao, _ = _inputs(s, d, 1, seed=d, b=b)
    q, m = qkv.numpy(), amask.numpy()
    kw = dict(tb=b, s=s, e=d, h=1)
    out, ps = jax_enc._attn_fwd(q, m[:, None, :], **kw)
    ao_c, o, stats = eb.attention_fwd_streamed_plain(qkv, amask, 1, torch.bfloat16)
    assert torch.equal(ao_c, o.to(torch.bfloat16))
    _close(o.numpy(), np.asarray(out), 2e-6, "ao")
    want = np.asarray(jax_enc._attn_bwd(dao.numpy(), q, ps, **kw))
    dqkv, _ = eb.attention_bwd_streamed_plain(qkv, amask, o, stats, dao, torch.bfloat16)
    _close(dqkv.numpy(), want, 2e-6, "dqkv")


WIDE_E, WIDE_L, WIDE_B = 512, 1, 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [20, 40])
def test_fused_encode_at_a_head_of_512_matches_the_jax_kernel(s, dtype):
    """E = 512 with one head (a head width the CUDA-core attention refused)
    through fused_encode (its plain version on CPU tensors), S = 20 on the
    staged route and 40 on the streamed one, against the JAX kernel."""
    assert enc.fits(s, WIDE_E, 1, WIDE_L)
    assert eb.attention_route(s, WIDE_E) == ("staged" if s == 20 else "streamed")
    params, x, ids = _encoder_case(WIDE_L, WIDE_B, seed=s, e=WIDE_E, s=s, heads=1)
    jd, td = DTYPES[dtype]
    want = np.asarray(jax_enc.fused_encode(params, jnp.asarray(x).astype(jd), jnp.asarray(ids),
                                           num_heads=1, block_b=8), np.float32)
    got = enc.fused_encode(to_pt(params), torch.from_numpy(x).to(td), torch.from_numpy(ids),
                           num_heads=1)
    assert got.dtype == td and got.shape == (WIDE_B, s, WIDE_E) and not got[0].any()
    atol = 3e-6 if dtype == "float32" else bf16_ulp(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [20, 40])
def test_encode_bwd_at_a_head_of_512_matches_the_jax_vjp(s, dtype):
    """dx and the 12 weight gradients of encode_bwd (its plain version here)
    at E = 512, one head, against jax.vjp of the JAX kernel's _fused."""
    b, e, heads, layers = WIDE_B, WIDE_E, 1, WIDE_L
    params, x, ids = _encoder_case(layers, b, seed=10 + s, e=e, s=s, heads=heads)
    jd, td = DTYPES[dtype]
    pp = to_pt(params)
    xm, am, pad = enc.encoder_inputs(pp, torch.from_numpy(x).to(td), torch.from_numpy(ids))
    g = np.random.default_rng(s).standard_normal((b, s, e)).astype(np.float32)
    g = torch.from_numpy(g * ~pad.numpy()[..., None]).to(td)
    ws = enc.stack_weights(pp, torch.float32)

    def f(xx, w):
        return jax_enc._fused(xx, jnp.asarray(am.numpy()), jnp.zeros((1,), jnp.float32), w,
                              s, e, heads, layers, 0.0, True, 8)

    jx = jnp.asarray(xm.float().numpy().reshape(b, s * e)).astype(jd)
    _, vjp = jax.vjp(f, jx, tuple(jnp.asarray(w.numpy()) for w in ws))
    dx, dws = vjp(jnp.asarray(g.float().numpy().reshape(b, s * e)).astype(jd))
    want = [np.asarray(dx, np.float32).reshape(b, s, e)] + [np.asarray(t) for t in dws]
    got = enc.encode_bwd(g, xm, am, *enc.cast_matrices(ws, td), num_heads=heads)
    share = 2e-6 if dtype == "float32" else 2.0**-8
    for name, a, w in zip(("dx",) + enc.WEIGHT_NAMES, got, want):
        a = a.float().numpy()
        _close(a, w, share, name)
        if dtype == "bfloat16":
            assert np.linalg.norm(a - w) <= 2.0**-12 * np.linalg.norm(w), name
