"""The kernels' shape predicates, the entry points that pad into them, and
the dispatch sites (CPU).

Each kernel family has one predicate, a pure function of shapes:
``ops/cuda/interaction.fits(f, e)``, ``ops/cuda/scoring.fits(f, e, h1, h2)``
and ``ops/cuda/sasrec_encoder.fits(s, e, num_heads, layers)``. The wrappers'
``check_*envelope`` raise through them on a CUDA tensor. The interaction's
entry point and ``prepare_score_params`` zero-pad E and the tower widths to
multiples of 8, so those two families take any E and any two-layer tower;
the encoder's kernels take any S (the attention's keys streamed in tiles)
and any E with E % H == 0 (zero-padded to their widths), at any head
width. The dispatch sites (``senet_bilinear_concat``, the trunk's
``_attention_field``, ``Predictor``) take the kernel path whenever
``use_pallas`` is set: outside ``fits`` the card refuses, it never hands
the call to plain PyTorch. Here: each predicate at the shapes the port
meets, the shared-memory formula that sets the encoder attention's route
(staged or streamed), the padded
entry points against the unpadded reference, the path each site picks (a
spy on the kernel entry point), and the port against the JAX package on
the same seeded inputs and carried-over weights.

Tolerances, each with its reason:
- ``fused_encode`` at S = 50 and 100 against the JAX ``fused_encode``
  (Pallas interpret mode): the bars of tests/test_torch_sasrec.py and
  tests/test_torch_sasrec_training.py. fp32 forward atol 3e-6 (summation
  order), bf16 one bf16 ulp of the largest magnitude (both round at the
  same points), fp32 gradients rtol 1e-5 / atol 1e-6 of the leaf's largest.
- model logits and Predictor probabilities: the bars of
  tests/test_torch_predictor.py. fp32 rtol 1e-4 / atol 1e-5; bf16 atol
  2e-2 and rank correlation above 0.995 (XLA and PyTorch round the bf16
  trunk and tower at different places).
- the padded entry points against the unpadded reference: fp32 within 1e-6
  (the forward) and rtol 1e-5 / atol 1e-6 of the largest (gradients): the
  squeeze's factor Ep / E on W1 moves one fp32 product by a rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.config.loader import microlens_features
from ctr_recommendation_tpu.data import ItemStore as JaxItemStore
from ctr_recommendation_tpu.features import build_feature_map as jax_build_fm
from ctr_recommendation_tpu.inference import Predictor as JaxPredictor
from ctr_recommendation_tpu.models import build_model as jax_build_model
from ctr_recommendation_tpu.ops.pallas.sasrec_encoder import fused_encode as jax_fused_encode
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.data import ItemStore
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm
from ctr_recommendation_tpu_torch.inference import Predictor, predictor
from ctr_recommendation_tpu_torch.models import get_model, trunk
from ctr_recommendation_tpu_torch.ops import attention as pt_attn
from ctr_recommendation_tpu_torch.ops import interaction as pt_inter
from ctr_recommendation_tpu_torch.ops.cuda import encoder_blocks as eb
from ctr_recommendation_tpu_torch.ops.cuda import interaction as k_inter
from ctr_recommendation_tpu_torch.ops.cuda import sasrec_encoder as enc
from ctr_recommendation_tpu_torch.ops.cuda import scoring as k_score
from ctr_recommendation_tpu_torch.tools import jax_bridge
from ctr_recommendation_tpu_torch.utils.tree import tree_map
from tests.conftest import make_batch
from tests.test_torch_predictor import rank_corr
from tests.test_torch_sasrec import DTYPES, _encoder_case, bf16_ulp, to_pt
from tests.test_torch_training import np_tree

torch.set_num_threads(2)


# ------------------------------------------------------------ the predicates

@pytest.mark.parametrize("f, e, want", [
    (6, 128, True), (6, 256, True), (12, 64, True), (2, 8, True), (6, 16, True),
    (6, 10, False), (6, 50, False), (6, 4, False), (1, 128, False), (0, 32, False)])
def test_interaction_predicate(f, e, want):
    """F >= 2 and E % 8 == 0; both check_*_envelope raise exactly outside."""
    assert k_inter.fits(f, e) is want
    for check in (k_inter.check_fwd_envelope, k_inter.check_bwd_envelope):
        if want:
            check(f, e)
        else:
            with pytest.raises(ValueError, match="F >= 2 and E % 8 == 0"):
                check(f, e)


@pytest.mark.parametrize("f, e, h1, h2, want", [
    (6, 128, 512, 256, True), (6, 256, 1024, 512, True), (6, 128, 768, 384, True),
    (6, 16, 32, 16, True), (6, 128, 100, 50, False), (6, 128, 104, 50, False),
    (6, 10, 512, 256, False), (6, 128, 512, 4, False), (1, 128, 512, 256, False)])
def test_scoring_predicate(f, e, h1, h2, want):
    """The interaction's predicate and a tower with H1, H2 multiples of 8."""
    assert k_score.fits(f, e, h1, h2) is want
    if want:
        k_score.check_envelope(f, e, h1, h2)
    else:
        with pytest.raises(ValueError, match="fused_score needs"):
            k_score.check_envelope(f, e, h1, h2)


ENCODER_SHAPES = [  # (S, E, H, L, fits)
    (20, 128, 2, 1, True), (32, 128, 2, 1, True), (33, 128, 2, 1, True),
    (50, 128, 2, 1, True), (64, 256, 2, 1, True), (100, 64, 2, 2, True),
    (100, 32, 2, 1, True), (128, 64, 4, 1, True), (115, 64, 1, 1, True),
    (83, 128, 1, 1, True), (1, 32, 1, 1, True),
    (116, 64, 1, 1, True), (84, 128, 1, 1, True), (129, 64, 4, 1, True),
    (200, 128, 2, 1, True), (200, 64, 4, 1, True), (50, 50, 1, 1, True),
    (20, 16, 2, 1, True), (20, 128, 3, 1, False), (20, 64, 32, 1, True),
    (0, 128, 2, 1, False), (20, 128, 2, 0, False), (20, 1024, 2, 1, True)]


@pytest.mark.parametrize("s, e, heads, layers, want", ENCODER_SHAPES)
def test_encoder_predicate(s, e, heads, layers, want):
    """S >= 1, E % H == 0, any head width D = E/H, L >= 1 (the attention
    streamed past what shared memory holds and, past 128 deep, its heads
    read in chunks; E off the kernels' multiples zero-padded); check_envelope
    raises exactly outside."""
    assert enc.fits(s, e, heads, layers) is want
    if want:
        enc.check_envelope(s, e, heads, layers)
    else:
        with pytest.raises(ValueError, match="envelope"):
            enc.check_envelope(s, e, heads, layers)


@pytest.mark.parametrize("s, d, fwd, bwd", [
    (50, 64, 41_000, 74_800), (50, 128, 79_400, 126_000), (200, 64, 164_000, 539_200),
    (115, 64, 94_300, 231_840), (116, 64, 95_120, 234_784), (83, 128, 131_804, 231_072),
    (84, 128, 133_392, 234_528)])
def test_shared_memory_formula(s, d, fwd, bwd):
    """csrc/sasrec_encoder.cuh attn_fwd_smem / attn_bwd_smem: q, k, v and the
    mask forward; q, k, v, g, P and dlog backward; rows of attn_ld(D). The
    staged attention takes (S, D) where both fit (staged_fits); the encoder
    routes it there only at heads deeper than 64 or S up to STAGED_S
    (attention_route), and takes every S (fits)."""
    assert (eb.attn_fwd_smem(s, d), eb.attn_bwd_smem(s, d)) == (fwd, bwd)
    fits = max(fwd, bwd) <= eb.MAX_SMEM
    assert eb.staged_fits(s, d) is fits and enc.fits(s, 2 * d, 2, 1)
    staged = fits and (d > 64 or s <= eb.STAGED_S)
    assert (eb.attention_route(s, d) == "staged") is staged


def test_the_largest_history_each_head_width_takes():
    """Every S up to 1024 fits at every head width D in {25, 32, 50, 64,
    128, 256, 288, 512}, with one and two heads; the staged attention keeps
    the histories up to STAGED_S at heads up to 64 deep, and at deeper heads
    those whose heads fit shared memory both ways (S = 83 at D = 128, S =
    50 at D = 256); the streamed one takes the rest."""
    for d in (25, 32, 50, 64, 128, 256, 288, 512):
        assert all(enc.fits(s, h * d, h, 1) for s in range(1, 1025) for h in (1, 2))
    largest = {d: max(s for s in range(1, 1025) if eb.attention_route(s, d) == "staged")
               for d in (32, 64, 128, 256)}
    assert largest == {32: 20, 64: 20, 128: 83, 256: 50}


# ------------------------------------------------ the padded entry points

@pytest.mark.parametrize("e, want", [(1, 8), (4, 8), (8, 8), (10, 16), (16, 16), (50, 56),
                                     (100, 104), (128, 128)])
def test_padded_width(e, want):
    assert k_inter.padded_width(e) == want and k_inter.fits(6, want)


@pytest.mark.parametrize("btype", ["all", "each"])
@pytest.mark.parametrize("e", [10, 4, 50])
def test_interaction_entry_pads_e_to_the_kernels(btype, e):
    """fused_senet_bilinear_concat at an E the kernels do not take runs
    zero-padded to padded_width(E) (the kernels' plain version here): the
    reference block's output and its gradients of x, the SENet and the
    bilinear weights, fp32 within 1e-6 (the squeeze's factor Ep / E moves
    W1's product by an fp32 rounding)."""
    from ctr_recommendation_tpu_torch.ops import bilinear, senet

    gen = torch.Generator().manual_seed(e)
    sp, bp = senet.init(gen, 6, 2), bilinear.init(gen, e, 6, btype)
    rng = np.random.default_rng(e)
    x = torch.from_numpy(rng.standard_normal((7, 6, e)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((7, 21 * e)).astype(np.float32))

    def run(fn):
        leaves = tree_map(lambda t: t.detach().clone().requires_grad_(), (sp, bp, x))
        out = fn(*leaves, bilinear_type=btype)
        flat = [leaves[2]] + [t for tree in leaves[:2] for t in jax_bridge.flatten(tree).values()]
        return out, torch.autograd.grad((out * g).sum(), flat)

    got, got_g = run(k_inter.fused_senet_bilinear_concat)
    want, want_g = run(pt_inter.senet_bilinear_concat_reference)
    assert got.shape == want.shape == (7, 21 * e)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-6, atol=1e-6)
    for a, w in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6 * max(1.0, w.abs().max().item()))


@pytest.mark.parametrize("btype", ["all", "each"])
@pytest.mark.parametrize("e, hidden", [(10, (100, 50)), (16, (100, 50)), (10, (32, 16)),
                                       (16, (32, 16))])
def test_scoring_weights_pad_to_the_kernels(btype, e, hidden):
    """prepare_score_params pads E and the tower to multiples of 8, inside
    the scoring kernel's predicate, with zero weights and biases; score_fwd
    on them computes the unpadded plain version's probabilities (fp32,
    within 1e-6)."""
    from ctr_recommendation_tpu_torch.ops import bilinear, mlp, senet

    gen = torch.Generator().manual_seed(e + hidden[0])
    sp, bp = senet.init(gen, 6, 2), bilinear.init(gen, e, 6, btype)
    tower, _ = mlp.init(gen, 21 * e, hidden, batch_norm=False)
    ws = k_score.prepare_score_params(sp, bp, tower, bilinear_type=btype,
                                      compute_dtype=torch.float32)
    w_bi, w1, w2 = ws[4], ws[5], ws[7]
    ep, h1p, h2p = (k_inter.padded_width(n) for n in (e, *hidden))
    assert (w_bi.shape[-1], w1.shape, w2.shape) == (ep, (21 * ep, h1p), (h1p, h2p))
    assert k_score.fits(6, ep, h1p, h2p)
    x = torch.from_numpy(np.random.default_rng(e).standard_normal((9, 6, e)).astype(np.float32))
    got = k_score.score_fwd(x, *ws, bilinear_type=btype)
    lins = [tower["layers"][0]["linear"], tower["layers"][1]["linear"], tower["out"]]
    w_bi0 = bp["w"] if btype == "all" else bp["w_each"]
    want = k_score.score_fwd_plain(
        x, *k_inter.senet_weights(sp, 6), w_bi0,
        *(t for lin in lins for t in (lin["w"], lin["b"])), bilinear_type=btype)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` (then run it)."""
    fn, calls = getattr(module, name), []

    def spy(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def _tiny(tiny_experiment, *, e=16, max_len=8, hidden=None, model="mm_fibinet",
          precision="float32", use_pallas=True, layers=1, heads=None):
    """The tiny experiment at width ``e``, history ``max_len``, tower
    ``hidden`` and ``heads`` attention heads (default the experiment's): the
    JAX (experiment, feature map, module, params, state, with BatchNorm stats
    moved off init) and the same weights in the port's form (experiment,
    feature map, params, state)."""
    ds = dataclasses.replace(tiny_experiment.dataset, features=microlens_features(
        item_vocab=200, cate_vocab=11, max_len=max_len, mm_dim=24))
    cfg = dataclasses.replace(
        tiny_experiment.model, model=model, embedding_dim=e, use_pallas=use_pallas,
        attn_num_layers=layers, hidden_units=hidden or tiny_experiment.model.hidden_units,
        attn_num_heads=heads or tiny_experiment.model.attn_num_heads,
        tower_dtype="float32" if precision == "float32" else "compute")
    exp = tiny_experiment.replace(
        dataset=ds, model=cfg,
        train=dataclasses.replace(tiny_experiment.train, compute_dtype=precision))
    fm = jax_build_fm(ds)
    module, params, state = jax_build_model(fm, cfg, jax.random.key(0))
    _, state = module.apply(params, state, fm, cfg,
                            make_batch(np.random.default_rng(3), 64, max_len=max_len),
                            train=True, rng=jax.random.key(1))
    pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
    pfm = pt_build_fm(pexp.dataset)
    pparams, pstate = jax_bridge.params_from_jax(np_tree(params), np_tree(state), pfm,
                                                 pexp.model)
    return exp, fm, module, params, state, pexp, pfm, pparams, pstate


@pytest.mark.parametrize("e, max_len", [(32, 50), (16, 8), (32, 200)])
def test_the_encoder_site_takes_the_kernel_path_with_use_pallas(monkeypatch, tiny_experiment, e,
                                                                max_len):
    """sasrec_fibinet's forward takes fused_encode whenever use_pallas is
    set, whatever the shape (on a CPU tensor its plain version; on the card
    the kernels, which refuse a shape outside ``fits``), and
    attention.encode only with use_pallas off."""
    *_, pexp, pfm, pparams, pstate = _tiny(tiny_experiment, e=e, max_len=max_len,
                                           model="sasrec_fibinet")
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(np.random.default_rng(4), 6, max_len=max_len).items()}
    fused = _spy(monkeypatch, trunk, "fused_encode")
    plain = _spy(monkeypatch, pt_attn, "encode")
    model = get_model("sasrec_fibinet")
    for use_pallas in (True, False):
        cfg = dataclasses.replace(pexp.model, use_pallas=use_pallas)
        model.apply(pparams, pstate, pfm, cfg, batch, compute_dtype=torch.float32)
    assert (len(fused), len(plain)) == (1, 1)


@pytest.mark.parametrize("hidden", [(32, 16), (100, 50)])
def test_the_predictor_takes_the_scoring_kernel_at_any_tower(monkeypatch, tiny_experiment,
                                                            hidden):
    """A folded 2-layer tower is served on the scoring kernel at (100, 50)
    as at (32, 16): prepare_score_params pads it. An unfolded Predictor
    takes the eval forward by choice."""
    *_, pexp, _, pparams, pstate = _tiny(tiny_experiment, hidden=hidden)
    calls = _spy(monkeypatch, predictor, "score_fwd")
    batch = make_batch(np.random.default_rng(5), 9)
    pred = Predictor(pexp, pparams, pstate, device="cpu")
    unfolded = Predictor(pexp, pparams, pstate, device="cpu", fold_bn=False)
    assert pred.use_fused and not unfolded.use_fused
    np.testing.assert_allclose(pred(batch).numpy(), unfolded(batch).numpy(), rtol=1e-4,
                               atol=1e-5)
    assert len(calls) == 1


# ------------------------------------------------------- against the JAX package

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [50, 100])
def test_fused_encode_past_32_matches_the_jax_kernel(s, dtype):
    """B = 6, E = 32, H = 2, L = 1: the port's fused_encode (its plain
    version on CPU tensors, the kernels' arithmetic) against the JAX kernel
    in interpret mode, at histories the kernels now take."""
    assert enc.fits(s, 32, 2, 1)
    params, x, ids = _encoder_case(1, 6, seed=s, e=32, s=s)
    jd, td = DTYPES[dtype]
    want = np.asarray(jax_fused_encode(params, jnp.asarray(x).astype(jd), jnp.asarray(ids),
                                       num_heads=2, block_b=8), np.float32)
    launches = enc.encode_fwd.launches
    got = enc.fused_encode(to_pt(params), torch.from_numpy(x).to(td), torch.from_numpy(ids),
                           num_heads=2)
    assert enc.encode_fwd.launches == launches  # a CPU tensor takes the plain version
    assert got.dtype == td and got.shape == (6, s, 32) and not got[0].any()
    atol = 3e-6 if dtype == "float32" else bf16_ulp(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("s", [50, 100])
def test_fused_encode_gradients_past_32_match_jax_grad(s):
    """d seq_emb, d pos_emb and every block leaf through FusedEncoder
    against jax.grad of the JAX fused_encode, fp32, dropout off."""
    params, x, ids = _encoder_case(1, 6, seed=s + 1, e=32, s=s)
    g = np.random.default_rng(s).standard_normal((6, s, 32)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jax_fused_encode(p, xx, jnp.asarray(ids), num_heads=2, block_b=8) * g)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    pp = tree_map(lambda t: t.requires_grad_(), to_pt(params))
    xt = torch.from_numpy(x).requires_grad_()
    out = enc.fused_encode(pp, xt, torch.from_numpy(ids), num_heads=2, train=True)
    leaves = [xt] + list(jax_bridge.flatten(pp).values())
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves, allow_unused=True)
    want = {"seq_emb": np.asarray(jgx), **jax_bridge.flatten(np_tree(jgp))}
    for name, a in zip(["seq_emb"] + list(jax_bridge.flatten(pp)), got):
        w = want[name]
        if name.startswith("pool_q"):  # fused_encode does not use the pooling query
            assert a is None and not w.any()
            continue
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(w).max()), err_msg=name)


def _close(got, want, precision):
    if precision == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2)
        assert rank_corr(got, want) > 0.995


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_mm_fibinet_at_e10_matches_jax(monkeypatch, tiny_experiment, precision):
    """mm_fibinet at E = 10, use_pallas on: the JAX model runs its Pallas
    interaction kernel in interpret mode (it pads only the batch, so E = 10
    runs on the CPU); the port runs its interaction entry point, which pads
    E to 16 for the kernels (their plain version here)."""
    exp, fm, module, params, state, pexp, pfm, pparams, pstate = _tiny(
        tiny_experiment, e=10, precision=precision)
    batch = make_batch(np.random.default_rng(6), 23)
    jd, td = DTYPES[precision]
    want, _ = module.apply(params, state, fm, exp.model, batch, compute_dtype=jd)
    calls = _spy(monkeypatch, k_inter, "fused_senet_bilinear_concat")
    got, _ = get_model("mm_fibinet").apply(
        pparams, pstate, pfm, pexp.model, {k: torch.from_numpy(v) for k, v in batch.items()},
        compute_dtype=td)
    assert len(calls) == 1
    _close(got.float().detach().numpy(), np.asarray(want, np.float32), precision)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_predictor_with_a_100_50_tower_matches_jax(tiny_experiment, precision):
    """A (100, 50) tower served: the JAX Predictor runs its fused Pallas
    scoring kernel in interpret mode (its only guard is a two-layer tower);
    the port's runs its scoring kernel (the plain version here) on the
    tower zero-padded to (104, 56)."""
    exp, _, _, params, state, pexp, _, pparams, pstate = _tiny(
        tiny_experiment, hidden=(100, 50), precision=precision)
    batch = make_batch(np.random.default_rng(7), 40)
    mm = np.zeros((200, 24), np.float32)
    mm[batch["item_id"]] = batch["item_emb_d128"]
    store = ItemStore.from_arrays(np.arange(200), mm)
    want = np.asarray(JaxPredictor(exp, params, state,
                                   item_store=JaxItemStore(store.emb, store.known_mask))(batch))
    pred = Predictor(pexp, pparams, pstate, device="cpu", item_store=store)
    got = pred(batch).numpy()
    assert pred.use_fused and pred._score_weights[5].shape[1] == 104
    _close(got, want, precision)


@pytest.mark.parametrize("max_len", [50, 200])
def test_sasrec_predictor_at_long_histories_matches_jax(monkeypatch, tiny_experiment, max_len):
    """sasrec_fibinet at E = 32, fp32, served on every kernel family's path
    (the plain versions here): at max_len 50 (SASRec's published n for its
    sparse datasets) and at 200 (its MovieLens-1M n), both of which the
    encoder kernels take streamed (``fits``, ``attention_route``). The JAX Predictor
    runs its Pallas encoder and scoring kernels in interpret mode at both."""
    exp, _, _, params, state, pexp, _, pparams, pstate = _tiny(
        tiny_experiment, e=32, max_len=max_len, model="sasrec_fibinet")
    batch = make_batch(np.random.default_rng(8), 16, max_len=max_len)
    batch["item_seq"][0] = 0  # an all-pad history
    mm = np.zeros((200, 24), np.float32)
    mm[batch["item_id"]] = batch["item_emb_d128"]
    store = ItemStore.from_arrays(np.arange(200), mm)
    want = np.asarray(JaxPredictor(exp, params, state,
                                   item_store=JaxItemStore(store.emb, store.known_mask))(batch))
    pred = Predictor(pexp, pparams, pstate, device="cpu", item_store=store)
    fused = _spy(monkeypatch, trunk, "fused_encode")
    got = pred(batch).numpy()
    assert pred.use_fused and len(fused) == 1
    assert enc.fits(max_len, 32, 2, 1)
    assert eb.attention_route(max_len, 16) == "streamed"
    _close(got, want, "float32")
