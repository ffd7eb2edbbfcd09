"""The scoring kernel's building blocks (ops/cuda/scoring.py) on the CPU.

A scoring call on a card is four blocks: the front (the concat
[S | pairs] in the tower dtype, the interaction forward's three launches),
two tower layers cd(relu(a w + b)) and the head sigmoid(h2 w3 + b3). Here
each block's plain version is held against the JAX package: the front
against the Pallas interaction kernel in interpret mode, the layers and
the head against the JAX scoring kernel's own expressions
(``ops/pallas/scoring.py::_kernel``) in jnp. Their composition,
``score_fwd_plain``, is held bit for bit against the single expression it
replaced, and against the Pallas scoring kernel by
tests/test_torch_kernels.py::test_score_plain_matches_pallas.

Tolerances: fp32 rtol 1e-4 / atol 1e-5 (summation order only). bf16: the
front within atol 5e-2, as the interaction kernel's test (XLA and PyTorch
round bf16 products at different places); a layer's output within one bf16
ulp (rtol 2^-7) plus 1e-5 of its largest element (fp32 sums in another
order can move a rounding or the ReLU's side of a value within rounding of
0); the head within 1e-5 (fp32 sums of the same bf16 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.ops import bilinear as jax_bilinear
from ctr_recommendation_tpu.ops import senet as jax_senet
from ctr_recommendation_tpu.ops.pallas.interaction import fused_senet_bilinear_concat as jax_fused
from ctr_recommendation_tpu_torch.ops.cuda import interaction as k_inter
from ctr_recommendation_tpu_torch.ops.cuda import scoring as k_score
from ctr_recommendation_tpu_torch.utils.tree import tree_map

torch.set_num_threads(2)

F, B = 6, 40
WIDTHS = ((32, (32, 16)), (256, (1024, 512)), (128, (768, 384)))


def to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def to_pt(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _operands(btype, dtype, e, hidden, seed=0):
    """Seeded JAX-initialised SENet and bilinear weights, x and a tower of
    the given widths, as the wrappers take them (torch, dtype cd)."""
    rng = np.random.default_rng(seed)
    sp = to_np(jax_senet.init(jax.random.key(seed + 1), F, 2))
    bp = to_np(jax_bilinear.init(jax.random.key(seed + 2), e, F, btype))
    x = rng.standard_normal((B, F, e)).astype(np.float32)
    cdim = (F + F * (F - 1) // 2) * e
    h1, h2 = hidden
    tower = []
    for k, n in ((cdim, h1), (h1, h2), (h2, 1)):
        tower += [rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k),
                  rng.normal(0, 0.1, n).astype(np.float32)]
    cd = getattr(torch, dtype)
    sw = k_inter.senet_weights(to_pt(sp), F)
    w_bi = torch.from_numpy(np.array(bp["w"] if btype == "all" else bp["w_each"])).to(cd)
    tw = [torch.from_numpy(t).to(cd if i % 2 == 0 else torch.float32)
          for i, t in enumerate(tower)]
    return sp, bp, torch.from_numpy(x).to(cd), sw, w_bi, tw


def _parent_score_plain(x, sw1, sb1, sw2, sb2, w_bi, w1, b1, w2, b2, w3, b3, btype):
    """score_fwd_plain as one expression, before it was split into blocks."""
    b, cd = x.shape[0], x.dtype
    s, p = k_inter.senet_bilinear_parts(x, sw1, sb1, sw2, sb2, w_bi, btype)
    c = torch.cat([s.reshape(b, -1), p.reshape(b, -1)], dim=-1)
    h1 = torch.relu(c.float() @ w1.float() + b1.float()).to(cd)
    h2 = torch.relu(h1.float() @ w2.float() + b2.float()).to(cd)
    return torch.sigmoid(h2.float() @ w3.float() + b3.float())[:, 0]


def _cases():
    return [pytest.param(btype, dtype, e, hidden,
                         id=f"{btype}-{dtype}-E{e}-{hidden[0]}x{hidden[1]}")
            for e, hidden in WIDTHS for dtype in ("float32", "bfloat16")
            for btype in ("all", "each")]


def _jnp_dtype(dtype):
    return jnp.dtype(dtype)


@pytest.mark.parametrize("btype, dtype, e, hidden", _cases())
def test_score_fwd_plain_is_the_composition_of_the_blocks(btype, dtype, e, hidden):
    """score_fwd_plain == front -> layer -> layer -> head, and bit for bit
    the single expression it was before."""
    _, _, x, sw, w_bi, tw = _operands(btype, dtype, e, hidden)
    got = k_score.score_fwd_plain(x, *sw, w_bi, *tw, bilinear_type=btype)
    c = k_score.score_front_plain(x, *sw, w_bi, bilinear_type=btype)
    h1 = k_score.tower_layer_plain(c, tw[0], tw[1])
    h2 = k_score.tower_layer_plain(h1, tw[2], tw[3])
    assert c.dtype == h1.dtype == h2.dtype == x.dtype
    assert torch.equal(got, k_score.score_head_plain(h2, tw[4], tw[5]))
    assert torch.equal(got, _parent_score_plain(x, *sw, w_bi, *tw, btype))


@pytest.mark.parametrize("btype, dtype, e", [
    pytest.param(btype, dtype, e, id=f"{btype}-{dtype}-E{e}")
    for e in (32, 256) for dtype in ("float32", "bfloat16") for btype in ("all", "each")])
def test_front_plain_matches_pallas_interaction(btype, dtype, e):
    """The front's concat, in cd, against the Pallas interaction kernel."""
    sp, bp, x, sw, w_bi, _ = _operands(btype, dtype, e, (32, 16), seed=1)
    want = np.asarray(jax_fused(sp, bp, jnp.asarray(x.float().numpy(), _jnp_dtype(dtype)),
                                bilinear_type=btype))
    before = k_score.score_front.launches
    got = k_score.score_front(x, *sw, w_bi, bilinear_type=btype)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert k_score.score_front.launches == before  # CPU tensors: no launch
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(rtol=0, atol=5e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("dtype, k, n", [
    pytest.param(dtype, k, n, id=f"{dtype}-{k}x{n}")
    for k, n in ((672, 32), (2688, 512), (1024, 512)) for dtype in ("float32", "bfloat16")])
def test_tower_layer_plain_matches_the_jax_kernels_layer(dtype, k, n):
    """cd(relu(a w + b)) as the JAX scoring kernel writes it."""
    rng = np.random.default_rng(k + n)
    a = rng.standard_normal((B, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    bias = rng.normal(0, 0.1, n).astype(np.float32)
    jd = _jnp_dtype(dtype)
    aj, wj = jnp.asarray(a, jd), jnp.asarray(w, jd)
    want = np.asarray(jnp.maximum(jnp.dot(aj, wj, preferred_element_type=jnp.float32)
                                  + bias, 0.0).astype(jd).astype(jnp.float32))
    cd = getattr(torch, dtype)
    before = k_score.tower_layer.launches
    got = k_score.tower_layer(torch.from_numpy(a).to(cd), torch.from_numpy(w).to(cd),
                              torch.from_numpy(bias))
    assert got.dtype == cd and got.shape == (B, n)
    assert k_score.tower_layer.launches == before
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0**-7,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype, h2", [
    pytest.param(dtype, h2, id=f"{dtype}-{h2}") for h2 in (16, 256, 512)
    for dtype in ("float32", "bfloat16")])
def test_score_head_plain_matches_the_jax_kernels_head(dtype, h2):
    """sigmoid(h2 w3 + b3) as the JAX scoring kernel writes it."""
    rng = np.random.default_rng(h2)
    h = np.maximum(rng.standard_normal((B, h2)), 0).astype(np.float32)
    w3 = (rng.standard_normal((h2, 1)) / np.sqrt(h2)).astype(np.float32)
    b3 = np.array([0.05], np.float32)
    jd = _jnp_dtype(dtype)
    want = np.asarray(jax.nn.sigmoid(
        jnp.dot(jnp.asarray(h, jd), jnp.asarray(w3, jd), preferred_element_type=jnp.float32)
        + b3))[:, 0]
    cd = getattr(torch, dtype)
    before = k_score.score_head.launches
    got = k_score.score_head(torch.from_numpy(h).to(cd), torch.from_numpy(w3).to(cd),
                             torch.from_numpy(b3))
    assert got.dtype == torch.float32 and got.shape == (B,)
    assert k_score.score_head.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_score_launches_counts_the_four_blocks():
    """The front is the interaction forward's launches; the two layers and
    the head one each."""
    assert k_score.score_launches() == k_inter.fwd_launches() + 3 == 6
    _, _, x, sw, w_bi, tw = _operands("all", "float32", 32, (32, 16))
    before = k_score.score_fwd.launches
    k_score.score_fwd(x, *sw, w_bi, *tw)
    assert k_score.score_fwd.launches == before  # CPU tensors take the plain version


@pytest.mark.parametrize("f, e, h1, h2", [
    (1, 128, 512, 256), (6, 12, 512, 256), (6, 0, 512, 256), (6, 128, 500, 256),
    (6, 128, 512, 20), (6, 256, 0, 256)])
def test_envelope_refuses_what_the_kernels_do_not_take(f, e, h1, h2):
    with pytest.raises(ValueError, match=r"fused_score needs F >= 2, E % 8 == 0.*got F="):
        k_score.check_envelope(f, e, h1, h2)


def test_envelope_holds_the_recorded_towers():
    for e in (128, 256):
        for h1, h2 in ((512, 256), (1024, 512), (768, 384)):
            k_score.check_envelope(F, e, h1, h2)
    k_score.check_envelope(F, 32, 32, 16)  # the tests' own small tower
    k_score.check_envelope(F, 8, 8, 8)


def test_block_wrappers_refuse_other_devices():
    x = torch.zeros(2, F, 32, device="meta")
    w = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k_score.score_front(x, w, w, w, w, w)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k_score.tower_layer(torch.zeros(2, 8, device="meta"), w, w)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k_score.score_head(torch.zeros(2, 8, device="meta"), w, w)


@pytest.mark.cuda
@pytest.mark.parametrize("btype, dtype, e, hidden", _cases())
def test_blocks_match_plain_on_the_card(btype, dtype, e, hidden):
    """On a card: each block's kernel against its plain version on the same
    inputs, the front also bit for bit against the interaction kernel's
    fp32 output, and score_fwd's launches. chip_smoke.py runs the same
    checks at full batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, x, sw, w_bi, tw = _operands(btype, dtype, e, hidden)
    x, w_bi = x.cuda(), w_bi.cuda()
    sw = [t.cuda() for t in sw]
    tw = [t.cuda() for t in tw]
    c = k_score.score_front(x, *sw, w_bi, bilinear_type=btype)
    want_c = k_score.score_front_plain(x, *sw, w_bi, bilinear_type=btype)
    fp32 = dtype == "float32"
    torch.testing.assert_close(c.float(), want_c.float(), rtol=1e-5 if fp32 else 2.0**-6,
                               atol=1e-5 if fp32 else 1e-3)
    inter = k_inter.interaction_fwd(x, *sw, w_bi, bilinear_type=btype)
    assert torch.equal(c, inter.to(x.dtype))
    for a, w, bias in ((want_c, tw[0], tw[1]),
                       (k_score.tower_layer_plain(want_c, tw[0], tw[1]), tw[2], tw[3])):
        got, want = k_score.tower_layer(a, w, bias).float(), k_score.tower_layer_plain(a, w, bias)
        want = want.float()
        share, rtol = (1e-5, 1e-5) if fp32 else (2.0**-7, 2.0**-7)
        assert ((got - want).abs() <= share * want.abs().max() + rtol * want.abs()).all()
    h2 = k_score.tower_layer_plain(k_score.tower_layer_plain(want_c, tw[0], tw[1]), tw[2], tw[3])
    torch.testing.assert_close(k_score.score_head(h2, tw[4], tw[5]),
                               k_score.score_head_plain(h2, tw[4], tw[5]), rtol=0, atol=1e-5)
    before = k_score.score_fwd.launches
    got = k_score.score_fwd(x, *sw, w_bi, *tw, bilinear_type=btype)
    assert k_score.score_fwd.launches == before + k_score.score_launches()
    torch.testing.assert_close(got, k_score.score_fwd_plain(x, *sw, w_bi, *tw, bilinear_type=btype),
                               rtol=0, atol=2e-5 if fp32 else 5e-3)
