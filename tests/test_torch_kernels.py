"""The port's kernel modules against the JAX package's Pallas kernels.

The CUDA kernels themselves cannot run on a machine without a card; their
plain PyTorch versions carry the same arithmetic and rounding points, and
chip_smoke.py holds each kernel against its plain version on the card. Here
each plain version (reached through the wrapper, as a CPU tensor takes it)
is held against the JAX kernel, which runs in Pallas interpret mode on the
CPU as tests/test_scoring_kernel.py runs it.

Tolerances: fp32 rtol 1e-4 / atol 1e-5 (summation order only). bf16
atol 5e-2 on interaction outputs and 2e-2 on probabilities: XLA and PyTorch
round bf16 products and sums at different places. The interaction backward
(through ``torch.autograd.grad`` against ``jax.vjp`` of the Pallas kernel):
fp32 rtol/atol 1e-5, the JAX package's own bar for its kernel; bf16 atol
2^-7 of each gradient's largest magnitude, since dv and dx are rounded to
bf16 after fp32 sums taken in another order, and a rounding landing one
bf16 ulp apart moves a gradient by up to that much; and, in bf16, the
difference's norm within 2^-12 of the gradient's (BWD_NORM_TOL). That one
catches a wrong rounding point: s or v rounded to bf16 where the forward
rounds them moves every gradient by 1e-3 to 6e-3 of its norm (inside the
elementwise bar), while the other summation order moves only the few
roundings that land one ulp apart (under 2e-5 of the norm here). The same
bars hold at E=256 and at the towers (1024, 512) and (768, 384), the wider
configurations of the JAX package's recipe sweep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.ops import bilinear as jax_bilinear
from ctr_recommendation_tpu.ops import mlp as jax_mlp
from ctr_recommendation_tpu.ops import senet as jax_senet
from ctr_recommendation_tpu.ops.pallas.interaction import fused_senet_bilinear_concat as jax_fused
from ctr_recommendation_tpu.ops.pallas.scoring import fused_score as jax_fused_score
from ctr_recommendation_tpu_torch.ops import interaction as pt_interaction
from ctr_recommendation_tpu_torch.ops import mlp as pt_mlp
from ctr_recommendation_tpu_torch.ops.cuda import interaction as k_inter
from ctr_recommendation_tpu_torch.ops.cuda import scoring as k_score
from ctr_recommendation_tpu_torch.utils.tree import tree_map

torch.set_num_threads(2)

F, E, B = 6, 32, 40
TOL = {
    ("interaction", "float32"): dict(rtol=1e-4, atol=1e-5),
    ("interaction", "bfloat16"): dict(rtol=0, atol=5e-2),
    ("score", "float32"): dict(rtol=1e-4, atol=1e-5),
    ("score", "bfloat16"): dict(rtol=0, atol=2e-2),
}
BWD_NORM_TOL = 2.0**-12


def to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def to_pt(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _weights(btype, seed=0, e=E):
    sp = to_np(jax_senet.init(jax.random.key(seed + 1), F, 2))
    bp = to_np(jax_bilinear.init(jax.random.key(seed + 2), e, F, btype))
    x = np.random.default_rng(seed).standard_normal((B, F, e)).astype(np.float32)
    return sp, bp, x


def _folded_tower(sp, bp, x, btype, hidden=(32, 16)):
    """A 2-layer tower (default (32, 16)) with BatchNorm stats moved off
    init, then folded."""
    cdim = (F + F * (F - 1) // 2) * x.shape[2]
    params, state = jax_mlp.init(jax.random.key(3), cdim, list(hidden), batch_norm=True)
    h = pt_interaction.senet_bilinear_concat_reference(
        to_pt(sp), to_pt(bp), torch.from_numpy(x), bilinear_type=btype).numpy()
    _, state = jax_mlp.apply(params, state, jnp.asarray(h), train=True)
    return to_np(jax_mlp.fold_batch_norm(params, state))


def _cases(widths):
    """(btype, dtype, *values) for each (values, tag) of ``widths``: the
    empty tag keeps the plain "btype-dtype" id; the wide configurations of
    the JAX package's recipe sweep (E=256, towers (1024, 512) and
    (768, 384)) add theirs."""
    return [pytest.param(btype, dtype, *values, id=f"{btype}-{dtype}{tag}")
            for values, tag in widths for dtype in ("float32", "bfloat16")
            for btype in ("all", "each")]


WIDE_E = 256
WIDE_TOWERS = ((1024, 512), (768, 384))


@pytest.mark.parametrize("btype, dtype, e", _cases([((E,), ""), ((WIDE_E,), f"-E{WIDE_E}")]))
def test_interaction_plain_matches_pallas(btype, dtype, e):
    sp, bp, x = _weights(btype, e=e)
    want = np.asarray(jax_fused(sp, bp, jnp.asarray(x, dtype), bilinear_type=btype))
    before = k_inter.interaction_fwd.launches
    got = k_inter.fused_senet_bilinear_concat(
        to_pt(sp), to_pt(bp), torch.from_numpy(x).to(getattr(torch, dtype)),
        bilinear_type=btype)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert k_inter.interaction_fwd.launches == before  # CPU tensors: no launch
    np.testing.assert_allclose(got.numpy(), want, **TOL[("interaction", dtype)])


@pytest.mark.parametrize("btype, dtype, e, hidden", _cases(
    [((E, (32, 16)), "")] + [((WIDE_E, h), f"-E{WIDE_E}-{h[0]}x{h[1]}") for h in WIDE_TOWERS]))
def test_score_plain_matches_pallas(btype, dtype, e, hidden):
    sp, bp, x = _weights(btype, seed=4, e=e)
    folded = _folded_tower(sp, bp, x, btype, hidden)
    want = np.asarray(jax_fused_score(
        sp, bp, folded, jnp.asarray(x), bilinear_type=btype, block_b=16,
        compute_dtype=jnp.dtype(dtype)))
    before = k_score.score_fwd.launches
    got = k_score.fused_score(
        to_pt(sp), to_pt(bp), to_pt(folded), torch.from_numpy(x),
        bilinear_type=btype, compute_dtype=getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == (B,)
    assert k_score.score_fwd.launches == before
    np.testing.assert_allclose(got.numpy(), want, **TOL[("score", dtype)])


@pytest.mark.parametrize("btype", ["all", "each"])
def test_score_plain_is_the_folded_eval_forward(btype):
    """fp32: interaction reference -> eval BatchNorm tower -> sigmoid."""
    sp, bp, x = _weights(btype, seed=5)
    cdim = (F + F * (F - 1) // 2) * E
    params, state = jax_mlp.init(jax.random.key(6), cdim, [32, 16], batch_norm=True)
    params, state = to_pt(to_np(params)), to_pt(to_np(state))
    for st in state["layers"]:
        st["bn_mean"] += 0.1
        st["bn_var"] *= 1.5
    h = pt_interaction.senet_bilinear_concat_reference(
        to_pt(sp), to_pt(bp), torch.from_numpy(x), bilinear_type=btype)
    want = torch.sigmoid(pt_mlp.apply(params, state, h)[0][:, 0])
    got = k_score.fused_score(
        to_pt(sp), to_pt(bp), pt_mlp.fold_batch_norm(params, state), torch.from_numpy(x),
        bilinear_type=btype)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


def test_ragged_batch_rows_are_independent():
    """A batch that is no multiple of any tile scores each row as alone."""
    sp, bp, x = _weights("all", seed=7)
    folded = to_pt(_folded_tower(sp, bp, x, "all"))
    full = k_score.fused_score(to_pt(sp), to_pt(bp), folded, torch.from_numpy(x))
    part = k_score.fused_score(to_pt(sp), to_pt(bp), folded, torch.from_numpy(x[:13]))
    np.testing.assert_allclose(part.numpy(), full[:13].numpy(), rtol=1e-6, atol=1e-7)


def test_score_rejects_towers_that_are_not_two_layers():
    sp, bp, x = _weights("all")
    cdim = (F + F * (F - 1) // 2) * E
    params, state = pt_mlp.init(torch.Generator().manual_seed(0), cdim, [32, 16, 8])
    with pytest.raises(ValueError, match="2-hidden-layer"):
        k_score.fused_score(
            to_pt(sp), to_pt(bp), pt_mlp.fold_batch_norm(params, state), torch.from_numpy(x))


def _pallas_vjp(btype, dtype, use_bias, b=37, e=E):
    """Seeded SENet/bilinear weights, x (b, F, e) and a cotangent g, and
    jax.vjp of the Pallas kernel (whose backward is _bwd_kernel) at g, as
    numpy arrays: (sp, bp, x, g, d senet params, d bilinear params, dx)."""
    sp = to_np(jax_senet.init(jax.random.key(1), F, 2, use_bias=use_bias))
    bp = to_np(jax_bilinear.init(jax.random.key(2), e, F, btype))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, F, e)).astype(np.float32)
    g = rng.standard_normal((b, (F + F * (F - 1) // 2) * e)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda s_, b_, x_: jax_fused(s_, b_, x_, bilinear_type=btype, block_b=16),
        sp, bp, jnp.asarray(x, dtype))
    return (sp, bp, x, g, *vjp(jnp.asarray(g)))


def _rel_norm(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def _bias_cases(btypes, dtypes):
    """(btype, dtype, use_bias, e) cases: E=32 keeps the plain
    "btype-dtype-use_bias" id, E=256 adds "-E256"."""
    return [
        pytest.param(btype, dtype, use_bias, e, id=f"{btype}-{dtype}-{use_bias}{tag}")
        for e, tag in ((E, ""), (WIDE_E, f"-E{WIDE_E}"))
        for use_bias in (True, False) for dtype in dtypes for btype in btypes
    ]


@pytest.mark.parametrize(
    "btype, dtype, use_bias, e", _bias_cases(("all", "each"), ("float32", "bfloat16")))
def test_interaction_backward_matches_pallas_vjp(btype, dtype, use_bias, e):
    """An arbitrary cotangent through FusedInteraction (the CPU tensors take
    interaction_bwd_plain) against jax.vjp of the Pallas kernel, whose
    backward is _bwd_kernel; B=37 is ragged for its 16-row tiles."""
    sp, bp, x, g, want_sp, want_bp, want_dx = _pallas_vjp(btype, dtype, use_bias, e=e)
    tsp = tree_map(lambda t: t.requires_grad_(), to_pt(sp))
    tbp = tree_map(lambda t: t.requires_grad_(), to_pt(bp))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    before = k_inter.interaction_bwd.launches
    out = k_inter.fused_senet_bilinear_concat(tsp, tbp, tx, bilinear_type=btype)
    names = sorted(jax.tree_util.tree_leaves_with_path(want_sp), key=str)
    leaves = [tsp[p[0].key][p[1].key] for p, _ in names]
    wkey = "w" if btype == "all" else "w_each"
    got = torch.autograd.grad(out, [*leaves, tbp[wkey], tx], torch.from_numpy(g))
    assert k_inter.interaction_bwd.launches == before  # CPU tensors: no launch
    assert got[-1].dtype == tx.dtype and all(t.dtype == torch.float32 for t in got[:-1])
    want = [w for _, w in names] + [want_bp[wkey], want_dx]
    assert len(got) == len(want) == (4 if use_bias else 2) + 2
    for gt, wt in zip(got, want):
        wt = np.asarray(wt, np.float32)
        tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
               else dict(rtol=0, atol=2.0**-7 * np.abs(wt).max()))
        np.testing.assert_allclose(gt.float().numpy(), wt, **tol)
        if dtype == "bfloat16":
            assert _rel_norm(gt.float().numpy(), wt) <= BWD_NORM_TOL


@pytest.mark.parametrize("btype, dtype, use_bias, e", [
    pytest.param(*c.values, id=c.id.replace("-bfloat16", ""))
    for c in _bias_cases(("all", "each"), ("bfloat16",))])
def test_bf16_backward_bar_rejects_the_forwards_rounding_points(btype, dtype, use_bias, e):
    """The control, interaction_bwd_plain with s and v rounded where the
    forward rounds them, passes the elementwise bf16 bar against the Pallas
    vjp but fails the norm bar: the bar tells the rounding points apart."""
    sp, bp, x, g, want_sp, want_bp, want_dx = _pallas_vjp(btype, dtype, use_bias, e=e)
    wkey = "w" if btype == "all" else "w_each"
    dx, dw1, _, dw2, _, dw_bi = k_inter.interaction_bwd_plain(
        torch.from_numpy(g), torch.from_numpy(x).to(torch.bfloat16),
        *k_inter.senet_weights(to_pt(sp), F), to_pt(bp)[wkey].to(torch.bfloat16),
        bilinear_type=btype, forward_rounding=True)
    pairs = [(dx.float(), want_dx), (dw1, want_sp["fc1"]["w"]), (dw2, want_sp["fc2"]["w"]),
             (dw_bi, want_bp[wkey])]
    for gt, wt in pairs:
        wt = np.asarray(wt, np.float32)
        np.testing.assert_allclose(gt.numpy(), wt, rtol=0, atol=2.0**-7 * np.abs(wt).max())
        assert _rel_norm(gt.numpy(), wt) > 2 * BWD_NORM_TOL


def test_interaction_bwd_plain_keeps_its_own_rounding_points():
    """In bf16 the backward recomputes s and v in fp32, so it is not the
    autograd of the forward's plain version, which rounds both."""
    sp, bp, x = _weights("all", seed=8)
    sw = k_inter.senet_weights(to_pt(sp), F)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    w_bi = to_pt(bp)["w"].to(torch.bfloat16)
    g = torch.randn(B, (F + F * (F - 1) // 2) * E, generator=torch.Generator().manual_seed(0))
    xr = xb.clone().requires_grad_()
    (auto_dx,) = torch.autograd.grad(
        k_inter.interaction_fwd_plain(xr, *sw, w_bi), xr, g)
    dx = k_inter.interaction_bwd_plain(g, xb, *sw, w_bi)[0]
    assert dx.dtype == torch.bfloat16 and not torch.equal(dx, auto_dx)
    # in fp32 there is no rounding point, and the two agree
    xf = torch.from_numpy(x).requires_grad_()
    (auto_dx,) = torch.autograd.grad(
        k_inter.interaction_fwd_plain(xf, *sw, to_pt(bp)["w"]), xf, g)
    dx = k_inter.interaction_bwd_plain(g, xf.detach(), *sw, to_pt(bp)["w"])[0]
    torch.testing.assert_close(dx, auto_dx, rtol=1e-5, atol=1e-5)


def test_wrappers_refuse_other_devices():
    x = torch.zeros(2, F, E, device="meta")
    w = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k_inter.interaction_fwd(x, w, w, w, w, w)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k_score.score_fwd(x, *([w] * 11))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k_inter.interaction_bwd(w, x, w, w, w, w, w)


@pytest.mark.cuda
@pytest.mark.parametrize("btype, e, hidden", [
    pytest.param(btype, e, hidden, id=btype + ("" if (e, hidden) == (128, (512, 256)) else
                                               f"-E{e}-{hidden[0]}x{hidden[1]}"))
    for e, hidden in ((128, (512, 256)), (256, (512, 256)), (128, (1024, 512)),
                      (256, (1024, 512)), (256, (768, 384)))
    for btype in ("all", "each")])
def test_kernels_match_plain_on_the_card(btype, e, hidden):
    """On a card: both kernels against their plain versions (bf16, the
    serving dtype), at the model's E=128 and (512, 256) tower, at E=256 and
    at the recipe sweep's wider towers. chip_smoke.py runs the same check at
    full batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ctr_recommendation_tpu_torch.ops import bilinear, senet

    gen = torch.Generator().manual_seed(0)
    b, cd = 70, torch.bfloat16
    sw = [t.cuda() for t in k_inter.senet_weights(senet.init(gen, F, 2), F)]
    bp = bilinear.init(gen, e, F, btype)
    w_bi = (bp["w"] if btype == "all" else bp["w_each"]).to("cuda", cd)
    x = torch.randn(b, F, e, generator=gen).to("cuda", cd)
    got = k_inter.interaction_fwd(x, *sw, w_bi, bilinear_type=btype)
    want = k_inter.interaction_fwd_plain(x, *sw, w_bi, bilinear_type=btype)
    torch.testing.assert_close(got, want, rtol=2.0**-6, atol=1e-3)
    cdim = (F + F * (F - 1) // 2) * e
    params, _ = pt_mlp.init(gen, cdim, list(hidden), batch_norm=False)
    tower = []
    for lin in (params["layers"][0]["linear"], params["layers"][1]["linear"], params["out"]):
        tower += [lin["w"].to("cuda", cd), lin["b"].cuda()]
    got = k_score.score_fwd(x, *sw, w_bi, *tower, bilinear_type=btype)
    want = k_score.score_fwd_plain(x, *sw, w_bi, *tower, bilinear_type=btype)
    torch.testing.assert_close(got, want, rtol=0, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("btype, dtype, e", [
    pytest.param(btype, dtype, e, id=f"{btype}-dtype{k}" + ("" if e == 128 else f"-E{e}"))
    for e in (128, 256) for k, dtype in enumerate((torch.bfloat16, torch.float32))
    for btype in ("all", "each")])
def test_interaction_bwd_matches_plain_on_the_card(btype, dtype, e):
    """On a card: the backward kernel against its plain version at E=128 and
    E=256 (weights staged in column blocks) on a ragged batch, bit-identical
    on a repeat launch. chip_smoke.py runs the same check at the training
    batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ctr_recommendation_tpu_torch.ops import bilinear, senet

    gen = torch.Generator().manual_seed(0)
    b = 333
    sw = [t.cuda() for t in k_inter.senet_weights(senet.init(gen, F, 2), F)]
    bp = bilinear.init(gen, e, F, btype)
    w_bi = (bp["w"] if btype == "all" else bp["w_each"]).to("cuda", dtype)
    x = torch.randn(b, F, e, generator=gen).to("cuda", dtype)
    g = torch.randn(b, (F + F * (F - 1) // 2) * e, generator=gen).cuda()
    got = k_inter.interaction_bwd(g, x, *sw, w_bi, bilinear_type=btype)
    again = k_inter.interaction_bwd(g, x, *sw, w_bi, bilinear_type=btype)
    want = k_inter.interaction_bwd_plain(g, x, *sw, w_bi, bilinear_type=btype)
    for a, c, w in zip(got, again, want):
        assert torch.equal(a, c)
        scale = w.float().abs().max().item()
        atol = (1e-5 if dtype == torch.float32 else 2.0**-7) * max(scale, 1.0)
        torch.testing.assert_close(a.float(), w.float(), rtol=1e-4, atol=atol)
        if dtype == torch.bfloat16:
            assert _rel_norm(a.float().cpu(), w.float().cpu()) <= BWD_NORM_TOL
    if dtype == torch.bfloat16:  # the forward's rounding points fail the bar
        control = k_inter.interaction_bwd_plain(
            g, x, *sw, w_bi, bilinear_type=btype, forward_rounding=True)
        assert max(_rel_norm(a.float().cpu(), w.float().cpu())
                   for a, w in zip(got, control)) > BWD_NORM_TOL
