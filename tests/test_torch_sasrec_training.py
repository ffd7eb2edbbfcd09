"""The port's sasrec_fibinet training path against the JAX package's (CPU).

Inputs are made with numpy from a seed (or come from the JAX package's own
init, moved across with tools/jax_bridge) and go through the JAX function
and its counterpart in the port. The encoder's kernels cannot run without a
card; their plain versions (``encode_fwd_plain``, ``encode_bwd_plain``,
reached through ``FusedEncoder`` on CPU tensors) carry the kernels'
arithmetic, rounding points and dropout masks, and are held here against
the JAX ``fused_encode``, whose Pallas kernels run in interpret mode on the
CPU as tests/test_sasrec_kernel.py runs them. Interpret mode has no TPU
PRNG, so with dropout on the oracle is autograd of the port's own forward
under the same seed. chip_smoke.py holds the kernels against the plain
versions on the card.

Tolerances, each with its reason:
- ``encode_bwd_plain`` against ``jax.vjp``: fp32 2e-6 of each output's
  largest magnitude (summation order only; 4e-7 measured). bf16 2^-8 of the
  largest magnitude and 2^-12 in norm: both round at the same points, so
  only an fp32 sum taken in another order can round one operand a bf16 ulp
  apart (2.7e-5 of the largest and 1.1e-5 in norm measured). The fp32-operand
  control reads 6e-4 to 3.5e-3 in norm (1.8e-3 to 2.0e-3 on the last layer's
  ffn2_w, which no ReLU gate separates from g) and must fail chip_smoke.py's
  ENC_BWD_GATE_FREE_TOL there.
- with dropout, against autograd of ``encode_fwd_plain``: fp32 2e-6 of the
  largest magnitude (another association of the same products).
- ``fused_encode`` gradients against ``jax.grad``: fp32 rtol 1e-5, atol
  1e-6 of the leaf's largest magnitude (summation order).
- model loss and gradients, ``fit_on_device``: the bars of
  tests/test_torch_training.py for MM-FiBiNET.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.data import ItemStore as JaxItemStore
from ctr_recommendation_tpu.data.parquet import TableData as JaxTableData
from ctr_recommendation_tpu.ops.pallas import sasrec_encoder as jax_enc
from ctr_recommendation_tpu.parallel.mesh import single_device_mesh
from ctr_recommendation_tpu.training import Trainer as JaxTrainer
from ctr_recommendation_tpu.training import bce_with_logits as jax_bce
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.data import ItemStore, TableData
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm
from ctr_recommendation_tpu_torch.models import get_model
from ctr_recommendation_tpu_torch.ops import attention as pt_attn
from ctr_recommendation_tpu_torch.ops.cuda import sasrec_encoder as enc
from ctr_recommendation_tpu_torch.tools import jax_bridge
from ctr_recommendation_tpu_torch.training import Trainer, bce_with_logits
from ctr_recommendation_tpu_torch.utils.tree import tree_map
from tests.conftest import make_batch
from tests.test_torch_sasrec import DTYPES, E, H, S, _encoder_case, _setup, to_np, to_pt
from tests.test_torch_training import _synthetic_split, np_tree

torch.set_num_threads(2)

import chip_smoke  # noqa: E402  (the card's bars, used here on the CPU)

KAT = [  # Random123's known-answer vectors for Philox4x32-10: (ctr, key, out)
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
SEED = 0x1234_5678_9ABC_DEF


def _seed(v=SEED):
    return torch.tensor([v], dtype=torch.int64)


# ------------------------------------------------------------- the generator
@pytest.mark.parametrize("ctr,key,out", KAT)
def test_philox_reproduces_the_known_answers(ctr, key, out):
    got = enc.philox4x32(ctr, key)
    assert tuple(int(w) for w in got) == out


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_mask_keeps_its_share(rate):
    """The kept share is within 6 sigma of a binomial with p = 1 - rate."""
    n = 4096 * 64
    keep = enc.dropout_mask(_seed(), 4096, 64, 1, 0, rate)
    assert keep.dtype == torch.bool and keep.shape == (4096, 64)
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(int(keep.sum()) - n * (1 - rate)) < 6 * sigma


def test_dropout_mask_depends_only_on_its_key():
    """Rows of a small batch equal the same tokens inside a larger one (the
    mask is keyed by the global token, never by a tile), and another seed,
    layer or branch draws another mask."""
    big = enc.dropout_mask(_seed(), 300, 128, 0, 1, 0.1)
    small = enc.dropout_mask(_seed(), 37, 128, 0, 1, 0.1)
    assert torch.equal(big[:37], small)
    assert torch.equal(enc.dropout_mask(SEED, 300, 128, 0, 1, 0.1), big)  # int seed alike
    for other in (enc.dropout_mask(_seed(SEED + 1), 300, 128, 0, 1, 0.1),
                  enc.dropout_mask(_seed(), 300, 128, 1, 1, 0.1),
                  enc.dropout_mask(_seed(), 300, 128, 0, 0, 0.1)):
        assert (other != big).float().mean() > 0.1
    # a seed above 2^32 keys with both words
    assert not torch.equal(enc.dropout_mask(_seed(SEED + (1 << 40)), 300, 128, 0, 1, 0.1), big)


# ------------------------------------------------------------ the backward
def _bwd_case(layers, b, dtype, seed=0):
    """(g, x, amask, pad, fp32 weights) on the CPU, g zero at pad rows (the
    output's re-zeroing gives that cotangent)."""
    params, x, ids = _encoder_case(layers, b, seed=seed)
    td = DTYPES[dtype][1]
    pp = to_pt(params)
    xm, am, pad = enc.encoder_inputs(pp, torch.from_numpy(x).to(td), torch.from_numpy(ids))
    g = np.random.default_rng(seed + 5).standard_normal((b, S, E)).astype(np.float32)
    g = torch.from_numpy(g * ~pad.numpy()[..., None]).to(td)
    return g, xm, am, pad, enc.stack_weights(pp, torch.float32)


def _jax_vjp(g, xm, am, ws, layers):
    """dx and the 12 weight gradients of the JAX kernel's custom_vjp."""
    b = xm.shape[0]
    jd = DTYPES["bfloat16" if xm.dtype == torch.bfloat16 else "float32"][0]
    jws = tuple(jnp.asarray(w.numpy()) for w in ws)
    jx = jnp.asarray(xm.float().numpy().reshape(b, S * E)).astype(jd)

    def f(x, w):
        return jax_enc._fused(x, jnp.asarray(am.numpy()), jnp.zeros((1,), jnp.float32), w,
                              S, E, H, layers, 0.0, True, 16)

    _, vjp = jax.vjp(f, jx, jws)
    dx, dws = vjp(jnp.asarray(g.float().numpy().reshape(b, S * E)).astype(jd))
    return [np.asarray(dx, np.float32).reshape(b, S, E)] + [np.asarray(t) for t in dws]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers,b", [(1, 24), (2, 23)])
def test_encode_bwd_plain_matches_the_jax_vjp(layers, b, dtype):
    """Rate 0: dx and every weight gradient against jax.vjp of the JAX
    kernel (row 0 is an all-pad history, row 1 has no pad)."""
    g, xm, am, pad, ws = _bwd_case(layers, b, dtype, seed=layers)
    want = _jax_vjp(g, xm, am, ws, layers)
    launches = enc.encode_bwd.launches
    got = enc.encode_bwd(g, xm, am, *enc.cast_matrices(ws, xm.dtype), num_heads=H)
    assert enc.encode_bwd.launches == launches  # a CPU tensor takes the plain version
    assert got[0].dtype == xm.dtype and all(t.dtype == torch.float32 for t in got[1:])
    share = 2e-6 if dtype == "float32" else 2.0**-8
    for name, a, w in zip(("dx",) + enc.WEIGHT_NAMES, got, want):
        a = a.float().numpy()
        assert a.shape == w.shape and np.isfinite(a).all(), name
        np.testing.assert_allclose(a, w, rtol=0, atol=share * np.abs(w).max(), err_msg=name)
        if dtype == "bfloat16":
            assert np.linalg.norm(a - w) <= 2.0**-12 * np.linalg.norm(w), name
    assert not got[0][0].any()  # the all-pad history gets no gradient


@pytest.mark.parametrize("layers", [1, 2])
def test_encode_bwd_plain_with_dropout_matches_autograd(layers):
    """Rate 0.1, fp32: the hand-derived VJP redraws the forward's masks from
    the seed, so it equals autograd of encode_fwd_plain under that seed."""
    g, xm, am, _, ws = _bwd_case(layers, 23, "float32", seed=10 + layers)
    leaves = [xm.clone().requires_grad_(), *(w.clone().requires_grad_() for w in ws)]
    out = enc.encode_fwd_plain(leaves[0], am, *leaves[1:], num_heads=H, seed=_seed(), rate=0.1)
    want = torch.autograd.grad(out, leaves, g)
    got = enc.encode_bwd_plain(g, xm, am, *ws, num_heads=H, seed=_seed(), rate=0.1)
    undropped = enc.encode_bwd_plain(g, xm, am, *ws, num_heads=H)
    for name, a, w, u in zip(("dx",) + enc.WEIGHT_NAMES, got, want, undropped):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0,
                                   atol=2e-6 * w.abs().max().item(), err_msg=name)
    assert not torch.allclose(got[0], undropped[0])  # the masks are really applied


def test_the_bf16_control_fails_the_norm_bar():
    """Every backward operand left in fp32 is a wrong bf16 backward: the last
    layer's ffn2_w moves past chip_smoke.py's gate-free norm bar (by 4x or
    more) in every case, while the right plain version passes every bar."""
    for layers, b in ((1, 24), (2, 23)):
        g, xm, am, _, ws = _bwd_case(layers, b, "bfloat16", seed=layers)
        right = enc.encode_bwd_plain(g, xm, am, *ws, num_heads=H)
        wrong = enc.encode_bwd_plain(g, xm, am, *ws, num_heads=H, fp32_operands=True)
        _, _, gate_free, bad = chip_smoke.check_encoder_bwd(torch, wrong, right, "bfloat16")
        assert "ffn2_w" in bad, (layers, bad)
        assert gate_free > 4 * chip_smoke.ENC_BWD_GATE_FREE_TOL["bfloat16"], (layers, gate_free)
        _, _, _, none = chip_smoke.check_encoder_bwd(torch, right, right, "bfloat16")
        assert none == []
        fp32_right = enc.encode_bwd_plain(g.float(), xm.float(), am, *ws, num_heads=H)
        fp32_ctl = enc.encode_bwd_plain(g.float(), xm.float(), am, *ws, num_heads=H,
                                        fp32_operands=True)
        assert all(torch.equal(a, c) for a, c in zip(fp32_right, fp32_ctl))


@pytest.mark.parametrize("layers", [1, 2])
def test_fused_encode_gradients_match_jax_grad(layers):
    """d seq_emb, d pos_emb and every block leaf through FusedEncoder against
    jax.grad of the JAX fused_encode, fp32, dropout off."""
    params, x, ids = _encoder_case(layers, 23, seed=20 + layers)
    g = np.random.default_rng(7).standard_normal((23, S, E)).astype(np.float32)

    def jloss(p, xx):
        out = jax_enc.fused_encode(p, xx, jnp.asarray(ids), num_heads=H, block_b=16)
        return jnp.sum(out * g)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    pp = tree_map(lambda t: t.requires_grad_(), to_pt(params))
    xt = torch.from_numpy(x).requires_grad_()
    out = enc.fused_encode(pp, xt, torch.from_numpy(ids), num_heads=H, train=True)
    leaves = [xt] + list(jax_bridge.flatten(pp).values())
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves, allow_unused=True)
    want = {"seq_emb": np.asarray(jgx), **jax_bridge.flatten(np_tree(jgp))}
    names = ["seq_emb"] + list(jax_bridge.flatten(pp))
    assert sorted(names) == sorted(want)
    for name, a in zip(names, got):
        w = want[name]
        if name.startswith("pool_q"):  # fused_encode does not use the pooling query
            assert a is None and not w.any()
            continue
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5, atol=1e-6 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def test_jnp_path_and_kernel_path_draw_the_same_mask():
    """With dropout on (fp32), attention.encode and fused_encode agree on
    every real row: the same masks at the same sites (atol 3e-6, the eval
    bar of test_torch_sasrec.py; the jnp path divides by 1 - rate where the
    kernel multiplies by its inverse, one ulp). Without the seed, or in eval
    mode, neither drops anything."""
    params, x, ids = _encoder_case(2, 23, seed=4)
    pp, xt, it = to_pt(params), torch.from_numpy(x), torch.from_numpy(ids)
    kw = dict(num_heads=H, train=True, dropout_rate=0.1, seed=_seed())
    jnp_path = pt_attn.encode(pp, xt, it, **kw)
    kernel_path = enc.fused_encode(pp, xt, it, **kw)
    real = it != 0
    torch.testing.assert_close(kernel_path[real], jnp_path[real], rtol=0, atol=3e-6)
    evaluated = enc.fused_encode(pp, xt, it, num_heads=H)
    assert (kernel_path[real] - evaluated[real]).abs().max() > 1e-2
    for off in (dict(train=False), dict(seed=None)):
        torch.testing.assert_close(enc.fused_encode(pp, xt, it, **{**kw, **off}), evaluated,
                                   rtol=0, atol=0)


# ----------------------------------------------------------------- the model
@pytest.mark.parametrize("use_pallas", [True, False])
def test_train_step_loss_and_gradients_match_jax(tiny_experiment, tiny_feature_map, use_pallas):
    """sasrec_fibinet in train mode, fp32, attn_dropout = net_dropout = 0:
    loss rtol 1e-5, every parameter gradient rtol 1e-4 / atol 1e-5 of the
    leaf's largest (tests/test_torch_training.py's bars)."""
    exp, module, params, state, pexp, pparams, pstate = _setup(
        tiny_experiment, tiny_feature_map, precision="float32", use_pallas=use_pallas, layers=2)
    cfg = dataclasses.replace(exp.model, attn_dropout=0.0, net_dropout=0.0)
    pcfg = dataclasses.replace(pexp.model, attn_dropout=0.0, net_dropout=0.0)
    rng = np.random.default_rng(2)
    batch = make_batch(rng, 48)
    batch["item_seq"][0] = 0  # an all-pad history
    labels = (rng.random(48) < 0.4).astype(np.float32)
    weight = np.ones(48, np.float32)
    weight[-5:] = 0.0

    def loss_fn(p):
        logits, new_state = module.apply(
            p, state, tiny_feature_map, cfg, batch, train=True, rng=jax.random.key(9),
            compute_dtype=jnp.float32, weight=jnp.asarray(weight),
        )
        return jax_bce(logits, jnp.asarray(labels), jnp.asarray(weight)), new_state

    (want_loss, _), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    leaves = list(jax_bridge.flatten(tree_map(lambda t: t.requires_grad_(), pparams)).values())
    launches = (enc.encode_fwd.launches, enc.encode_bwd.launches)
    logits, _ = get_model("sasrec_fibinet").apply(
        pparams, pstate, pt_build_fm(pexp.dataset), pcfg,
        {k: torch.from_numpy(v) for k, v in batch.items()}, train=True,
        generator=torch.Generator().manual_seed(3), compute_dtype=torch.float32,
        weight=torch.from_numpy(weight),
    )
    loss = bce_with_logits(logits, torch.from_numpy(labels), torch.from_numpy(weight))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    assert (enc.encode_fwd.launches, enc.encode_bwd.launches) == launches
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    flat_want = jax_bridge.flatten(np_tree(want_grads))
    flat_got = jax_bridge.flatten(pparams)
    assert len(grads) == len(flat_want) == len(flat_got)
    assert "trunk/attn/item_seq/blocks/1/qkv/w" in flat_got
    for path, g in zip(flat_got, grads):
        w = flat_want[path]
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=path)


def test_train_mode_draws_the_encoder_seed_from_the_generator(tiny_experiment,
                                                              tiny_feature_map):
    """With attn_dropout on (net_dropout off), train-mode logits depend on
    the generator's seed and replay under the same seed; eval mode and a
    train call without a generator drop nothing."""
    _, _, _, _, pexp, pparams, pstate = _setup(tiny_experiment, tiny_feature_map,
                                               precision="float32")
    cfg = dataclasses.replace(pexp.model, attn_dropout=0.3, net_dropout=0.0)
    fm = pt_build_fm(pexp.dataset)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(np.random.default_rng(5), 32).items()}
    model = get_model("sasrec_fibinet")

    def logits(**kw):
        with torch.no_grad():
            return model.apply(pparams, pstate, fm, cfg, batch, **kw)[0]

    a = logits(train=True, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, logits(train=True, generator=torch.Generator().manual_seed(1)),
                               rtol=0, atol=0)
    assert not torch.equal(a, logits(train=True, generator=torch.Generator().manual_seed(2)))
    plain = logits(train=False)
    assert not torch.equal(a, plain)
    # BatchNorm takes batch statistics in train mode; with no generator the
    # encoder drops nothing, so only the tower's normalization differs
    nogen = logits(train=True)
    cfg0 = dataclasses.replace(cfg, attn_dropout=0.0)
    with torch.no_grad():
        ref = model.apply(pparams, pstate, fm, cfg0, batch, train=True,
                          generator=torch.Generator().manual_seed(1))[0]
    torch.testing.assert_close(nogen, ref, rtol=0, atol=0)


# ----------------------------------------------------------- the slice whole
def _sasrec_exp(tiny_experiment, tmp, *, attn_dropout=0.0, **train_kw):
    cfg = dataclasses.replace(
        tiny_experiment.model, model="sasrec_fibinet", use_pallas=True, net_dropout=0.0,
        attn_dropout=attn_dropout, tower_dtype="float32",
    )
    train = dataclasses.replace(
        tiny_experiment.train, compute_dtype="float32", shuffle=False, epochs=2,
        checkpoint_dir=str(tmp), eval_batch_size=256, log_every=10_000,
        async_checkpointing=False, tensorboard=False, **train_kw,
    )
    return tiny_experiment.replace(model=cfg, train=train)


def test_fit_on_device_matches_jax(tiny_experiment, tmp_path):
    """Trainer.fit_on_device against the JAX one from the same initial
    weights (fp32, no shuffling, dropouts 0, the encoder and interaction on
    their kernels' paths both sides): per-epoch loss within 1e-3, AUC within
    5e-3; then the best export serves with the trainer's AUC (2e-3)."""
    from ctr_recommendation_tpu_torch.inference import Predictor
    from ctr_recommendation_tpu_torch.training import metrics as pt_metrics

    train, valid, ids, emb = _synthetic_split(768, 384, seed=3)
    exp = _sasrec_exp(tiny_experiment, tmp_path / "jax")
    spe = 768 // exp.train.batch_size
    jt = JaxTrainer(exp, mesh=single_device_mesh(), steps_per_epoch=spe,
                    item_store=JaxItemStore.from_arrays(ids, emb), log_fn=lambda s: None)
    pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
    pexp = pexp.replace(train=dataclasses.replace(pexp.train, checkpoint_dir=str(tmp_path / "pt")))
    fm = pt_build_fm(pexp.dataset)
    pparams, pstate = jax_bridge.params_from_jax(
        np_tree(jt.state.params), np_tree(jt.state.model_state), fm, pexp.model)
    store = ItemStore.from_arrays(ids, emb)
    pt = Trainer(pexp, steps_per_epoch=spe, item_store=store, params=pparams,
                 model_state=pstate, device="cpu", log_fn=lambda s: None)

    want = jt.fit_on_device(JaxTableData(train, 768), JaxTableData(valid, 384))
    got = pt.fit_on_device(TableData(train, 768), TableData(valid, 384))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert abs(g["train_loss"] - w["train_loss"]) < 1e-3, (g, w)
        assert abs(g["auc"] - w["auc"]) < 5e-3, (g, w)
    assert got[-1]["train_loss"] < got[0]["train_loss"]
    assert pt.state.step == int(jt.state.step) == 2 * spe

    params, state = jax_bridge.params_from_jax(*pt.ckpt.restore_best(), fm, pexp.model)
    pred = Predictor(pexp, params, state, item_store=store, device="cpu")
    assert pred.use_fused
    probs = pred.score_table(TableData(valid, 384), batch_size=128)
    served = pt_metrics.auc(torch.from_numpy(valid["label"]), torch.from_numpy(probs)).item()
    assert abs(served - max(h["auc"] for h in got)) < 2e-3
    pt.load_best()
    assert abs(pt.evaluate_table(TableData(valid, 384))["auc"] - served) < 2e-3


def test_resume_with_attention_dropout_equals_an_uninterrupted_run(tiny_experiment, tmp_path):
    """attn_dropout 0.1 and net_dropout 0.2, shuffled: a run cut after 2
    epochs and resumed for the third equals 3 epochs in one go, bit for bit
    (the step generator is reseeded from (seed + 1, step), so the encoder's
    seeds and masks replay)."""
    train, valid, ids, emb = _synthetic_split(512, 256, seed=1)
    store = ItemStore.from_arrays(ids, emb)
    spe = 512 // 64

    def trainer(epochs, ckpt):
        e = pt_serialize.from_json(jax_serialize.to_json(
            _sasrec_exp(tiny_experiment, ckpt, attn_dropout=0.1)))
        e = e.replace(
            model=dataclasses.replace(e.model, net_dropout=0.2),
            train=dataclasses.replace(e.train, epochs=epochs, shuffle=True),
        )
        return Trainer(e, total_steps=3 * spe, item_store=store, device="cpu",
                       log_fn=lambda s: None)

    whole = trainer(3, tmp_path / "whole")
    whole.fit_on_device(TableData(train, 512), TableData(valid, 256))
    first = trainer(2, tmp_path / "cut")
    first.fit_on_device(TableData(train, 512), TableData(valid, 256))
    resumed = trainer(3, tmp_path / "cut")
    hist = resumed.fit_on_device(TableData(train, 512), TableData(valid, 256), resume=True)
    assert len(hist) == 1 and resumed.state.step == 3 * spe
    for a, b in zip(resumed.param_leaves, whole.param_leaves):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert hist[0]["auc"] == whole.history[-1]["auc"]


def test_train_then_predict_cli_on_the_ports_own_export(tmp_path):
    """--model sasrec_fibinet trains on a tiny synthetic set (the encoder's
    plain versions on the CPU), the predict CLI serves the port's own
    best/export.npz without --weights, and the export round-trips through
    params_from_jax with its encoder blocks."""
    from ctr_recommendation_tpu_torch.cli.predict import main as predict_main
    from ctr_recommendation_tpu_torch.cli.train import main as train_main
    from ctr_recommendation_tpu_torch.config import serialize

    data, ckpt, out = tmp_path / "data", tmp_path / "ckpt", tmp_path / "out"
    rc = train_main([
        "--synthetic", str(data), "--synthetic-rows", "3000", "--synthetic-items", "300",
        "--epochs", "1", "--embedding-dim", "16", "--batch-size", "256", "--model",
        "sasrec_fibinet", "--checkpoint-dir", str(ckpt), "--device", "cpu",
    ])
    assert rc == 0
    assert (ckpt / "best" / "export.npz").exists() and (ckpt / "ckpt_1.pt").exists()
    exp = serialize.load(str(ckpt / "experiment.json"))
    assert exp.model.model == "sasrec_fibinet" and exp.model.attn_dropout == 0.1
    params, state = jax_bridge.params_from_jax(
        *jax_bridge.load(str(ckpt / "best" / "export.npz")), pt_build_fm(exp.dataset), exp.model)
    blocks = params["trunk"]["attn"]["item_seq"]["blocks"]
    assert isinstance(blocks, list) and len(blocks) == exp.model.attn_num_layers
    assert all(torch.isfinite(t).all() for t in jax_bridge.flatten(params).values())
    rc = predict_main([
        "--data-root", str(data), "--checkpoint-dir", str(ckpt), "--out-dir", str(out),
        "--batch-size", "128", "--model", "sasrec_fibinet", "--device", "cpu",
    ])
    assert rc == 0
    lines = (out / "prediction_fibinet.csv").read_text().splitlines()
    assert lines[0] == "ID,Task2" and len(lines) == 1 + 300
    probs = np.asarray([float(ln.split(",")[1]) for ln in lines[1:]])
    assert np.isfinite(probs).all() and ((probs > 0) & (probs < 1)).all()


def test_the_jax_export_of_a_trained_sasrec_round_trips(tmp_path, tiny_experiment,
                                                        tiny_feature_map):
    """A port-trained sasrec_fibinet export saved with jax_bridge.save loads
    back leaf for leaf, and a JAX tree of the same model converts into it."""
    _, _, params, state, pexp, pparams, pstate = _setup(tiny_experiment, tiny_feature_map,
                                                        precision="float32", layers=2)
    path = str(tmp_path / "w.npz")
    jax_bridge.save(path, pparams, pstate)
    again, again_state = jax_bridge.params_from_jax(*jax_bridge.load(path),
                                                    pt_build_fm(pexp.dataset), pexp.model)
    for k, v in jax_bridge.flatten(again).items():
        np.testing.assert_array_equal(v.numpy(), jax_bridge.flatten(pparams)[k].numpy())
    for k, v in jax_bridge.flatten(to_np(params)).items():
        np.testing.assert_array_equal(jax_bridge.flatten(again)[k].numpy(), v)
    assert jax_bridge.flatten(again_state).keys() == jax_bridge.flatten(pstate).keys()
