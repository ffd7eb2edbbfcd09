"""The port's sasrec_fibinet serving path against the JAX package's (CPU).

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in the port. The encoder kernel cannot run without a card;
its plain version (``encode_fwd_plain``, reached through ``fused_encode`` on
a CPU tensor) carries the kernel's arithmetic and rounding points, and is
held here against the JAX ``fused_encode``, which runs the Pallas kernel in
interpret mode on the CPU as tests/test_sasrec_kernel.py runs it.
chip_smoke.py holds the kernel against the plain version on the card.

Tolerances, each with its reason:
- ``fused_encode`` fp32: atol 3e-6, the JAX package's own bar for its kernel
  against the jnp path (summation order only).
- ``fused_encode`` bf16: one bf16 ulp of the output's largest magnitude. Both
  sides round at the same points (the stream, LayerNorm and attention fp32,
  the products' operands and the output bf16), so only a rounding that lands
  one ulp apart after fp32 sums taken in another order can differ.
- ``attention.encode`` fp32: atol 3e-6. bf16: four bf16 ulps of the output's
  largest magnitude: LayerNorm and softmax run in bf16 there, and XLA and
  PyTorch round their internal sums at different places (2 ulps measured).
- ``target_pool``: fp32 atol 1e-6; bf16 two ulps of the largest magnitude
  (the query, logits, softmax and pooled sum are all bf16, rounded at
  different places inside; one ulp measured).
- Model logits and Predictor probabilities: see each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.config import serialize as jax_serialize
from ctr_recommendation_tpu.inference import Predictor as JaxPredictor
from ctr_recommendation_tpu.models import build_model as jax_build_model
from ctr_recommendation_tpu.ops import attention as jax_attn
from ctr_recommendation_tpu.ops.pallas.sasrec_encoder import fused_encode as jax_fused_encode
from ctr_recommendation_tpu_torch.config import serialize as pt_serialize
from ctr_recommendation_tpu_torch.data import TableData
from ctr_recommendation_tpu_torch.features import build_feature_map as pt_build_fm
from ctr_recommendation_tpu_torch.inference import Predictor
from ctr_recommendation_tpu_torch.models import get_model
from ctr_recommendation_tpu_torch.ops import attention as pt_attn
from ctr_recommendation_tpu_torch.ops.cuda import sasrec_encoder as enc
from ctr_recommendation_tpu_torch.ops.cuda.interaction import interaction_fwd
from ctr_recommendation_tpu_torch.ops.cuda.scoring import score_fwd
from ctr_recommendation_tpu_torch.tools import jax_bridge
from ctr_recommendation_tpu_torch.utils.tree import tree_map
from tests.conftest import make_batch

torch.set_num_threads(2)

E, H, S = 16, 2, 8  # the tiny_experiment's width, heads and max_len
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CASES = [(1, 24), (2, 23)]  # (layers, batch)


def to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def to_pt(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def bf16_ulp(x: np.ndarray) -> float:
    """The bf16 ulp at the largest magnitude of x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _encoder_case(layers, b, seed=0, e=E, s=S, heads=H):
    """JAX encoder params, a history (B, S, E) and ids with one all-pad row
    (row 0) and one without pad (row 1)."""
    params = to_np(jax_attn.init(jax.random.key(seed), e, s, num_heads=heads, num_layers=layers))
    rng = np.random.default_rng(seed)
    ids = np.where(rng.random((b, s)) < 0.4, 0, rng.integers(1, 500, (b, s))).astype(np.int32)
    ids[0] = 0
    ids[1] = rng.integers(1, 500, s)
    x = rng.standard_normal((b, s, e)).astype(np.float32)
    return params, x, ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers,b", CASES)
def test_encode_matches_jax(layers, b, dtype):
    params, x, ids = _encoder_case(layers, b)
    jd, td = DTYPES[dtype]
    want = np.asarray(
        jax_attn.encode(params, jnp.asarray(x).astype(jd), jnp.asarray(ids), num_heads=H),
        np.float32,
    )
    got = pt_attn.encode(
        to_pt(params), torch.from_numpy(x).to(td), torch.from_numpy(ids), num_heads=H
    )
    assert got.dtype == td
    atol = 3e-6 if dtype == "float32" else 4 * bf16_ulp(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    assert not got[0].any()  # pad rows are zeroed


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers,b", CASES)
def test_fused_encode_matches_the_jax_kernel(layers, b, dtype):
    params, x, ids = _encoder_case(layers, b, seed=layers)
    jd, td = DTYPES[dtype]
    want = np.asarray(
        jax_fused_encode(params, jnp.asarray(x).astype(jd), jnp.asarray(ids), num_heads=H,
                         block_b=16),
        np.float32,
    )
    launches = enc.encode_fwd.launches
    got = enc.fused_encode(
        to_pt(params), torch.from_numpy(x).to(td), torch.from_numpy(ids), num_heads=H
    )
    assert enc.encode_fwd.launches == launches  # a CPU tensor takes the plain version
    assert got.dtype == td and got.shape == (b, S, E)
    atol = 3e-6 if dtype == "float32" else bf16_ulp(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    assert (got[0] == 0).all()  # the all-pad row is exactly 0
    assert (got[torch.from_numpy(ids == 0)] == 0).all()


def test_the_bf16_contract_differs_from_the_jnp_rounding_points():
    """In bf16 the kernel's contract (fp32 stream, LayerNorm and softmax) is
    not the jnp ``encode``'s: the two must differ by more than the one-ulp
    bar above, or that bar could not tell them apart. In fp32 they agree."""
    params, x, ids = _encoder_case(2, 23, seed=2)
    pp, xt, it = to_pt(params), torch.from_numpy(x), torch.from_numpy(ids)
    for dtype, far in (("bfloat16", True), ("float32", False)):
        td = DTYPES[dtype][1]
        kern = enc.fused_encode(pp, xt.to(td), it, num_heads=H).float().numpy()
        jnp_path = pt_attn.encode(pp, xt.to(td), it, num_heads=H).float().numpy()
        d = np.abs(kern - jnp_path).max()
        assert (d > bf16_ulp(kern)) == far, (dtype, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_target_pool_matches_jax(dtype):
    params, x, ids = _encoder_case(1, 24, seed=3)
    ids[5] = 0  # a second all-pad row
    jd, td = DTYPES[dtype]
    target = np.random.default_rng(4).standard_normal((24, E)).astype(np.float32)
    want = np.asarray(
        jax_attn.target_pool(params, jnp.asarray(x).astype(jd), jnp.asarray(ids),
                             jnp.asarray(target).astype(jd)),
        np.float32,
    )
    got = pt_attn.target_pool(
        to_pt(params), torch.from_numpy(x).to(td), torch.from_numpy(ids),
        torch.from_numpy(target).to(td),
    )
    assert got.dtype == td and got.shape == (24, E)
    atol = 1e-6 if dtype == "float32" else 2 * bf16_ulp(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    assert not got[0].any() and not got[5].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_mean_matches_jax(dtype):
    """The trunk's last-resort attention query: fp32 atol 1e-6; bf16 one ulp
    of the largest magnitude (one rounded division either side)."""
    from ctr_recommendation_tpu.ops import pooling as jax_pooling
    from ctr_recommendation_tpu_torch.ops import pooling as pt_pooling

    _, x, ids = _encoder_case(1, 24, seed=6)
    jd, td = DTYPES[dtype]
    want = np.asarray(jax_pooling.masked_mean(jnp.asarray(x).astype(jd), jnp.asarray(ids)),
                      np.float32)
    got = pt_pooling.masked_mean(torch.from_numpy(x).to(td), torch.from_numpy(ids))
    atol = 1e-6 if dtype == "float32" else bf16_ulp(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    assert not got[0].any()


def test_stack_weights_order_and_dtypes():
    params, _, _ = _encoder_case(2, 4)
    ws = enc.stack_weights(to_pt(params), torch.bfloat16)
    assert len(ws) == len(enc.WEIGHT_NAMES) == 12
    shapes = [tuple(t.shape) for t in ws]
    assert shapes == [(2, E, 3 * E), (2, 3 * E), (2, E, E), (2, E), (2, E), (2, E),
                      (2, E, 4 * E), (2, 4 * E), (2, 4 * E, E), (2, E), (2, E), (2, E)]
    assert [t.dtype for t in ws] == [
        torch.bfloat16 if n.endswith("_w") else torch.float32 for n in enc.WEIGHT_NAMES
    ]
    np.testing.assert_array_equal(ws[6][1].float().numpy(),
                                  to_pt(params)["blocks"][1]["ffn1"]["w"].bfloat16().float())


def test_encode_fwd_refuses_outside_the_envelope_and_training():
    """encode_fwd and encode_bwd run on CUDA (the kernels) or CPU (their
    plain versions) tensors, nothing else, and refuse dropout arguments
    they cannot honour (a rate outside [0, 1), a rate without a seed) on
    any device. Training itself is no longer refused: fused_encode with
    dropout runs (tests/test_torch_sasrec_training.py)."""
    params, x, ids = _encoder_case(1, 4)
    pp = to_pt(params)
    xm, am, _ = enc.encoder_inputs(pp, torch.from_numpy(x), torch.from_numpy(ids))
    ws = enc.stack_weights(pp, torch.float32)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        enc.encode_fwd(xm.to("meta"), am, *ws, num_heads=H)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        enc.encode_bwd(xm.to("meta"), xm.to("meta"), am, *ws, num_heads=H)
    seed = torch.tensor([3], dtype=torch.int64)
    for kw, msg in ((dict(seed=seed, rate=1.0), r"\[0, 1\)"), (dict(rate=0.1), "needs a seed")):
        with pytest.raises(ValueError, match=msg):
            enc.encode_fwd(xm, am, *ws, num_heads=H, **kw)
        with pytest.raises(ValueError, match=msg):
            enc.encode_bwd(xm, xm, am, *ws, num_heads=H, **kw)
    out = enc.fused_encode(pp, torch.from_numpy(x), torch.from_numpy(ids), num_heads=H,
                           train=True, dropout_rate=0.1, seed=seed)
    assert out.shape == (4, S, E) and torch.isfinite(out).all()


def test_library_layer_equals_the_plain_version():
    """torch.nn.TransformerEncoderLayer (chip_smoke.py's timing yardstick),
    with the mapped weights, computes encode_fwd_plain's function in fp32 on
    every history with a real step: atol 2e-5 (another summation order and
    -inf against -1e9 at pad keys, which both give exactly 0 weight)."""
    import chip_smoke

    params, x, ids = _encoder_case(1, 24, seed=5, e=32, heads=2)
    pp = to_pt(params)
    xm, am, pad = enc.encoder_inputs(pp, torch.from_numpy(x), torch.from_numpy(ids))
    ws = enc.stack_weights(pp, torch.float32)
    want = enc.encode_fwd_plain(xm, am, *ws, num_heads=2)
    layer = chip_smoke.library_layer(torch, ws, num_heads=2, device="cpu")
    with torch.inference_mode():
        got = layer(xm, src_key_padding_mask=pad)
    real = ~pad.all(-1)
    assert int(real.sum()) == 23
    np.testing.assert_allclose(got[real].numpy(), want[real].numpy(), rtol=0, atol=2e-5)


# ---------------------------------------------------------------- the model


def _setup(tiny_experiment, tiny_feature_map, *, precision="bfloat16", use_pallas=True,
           btype="all", layers=1):
    """A JAX sasrec_fibinet (its own init, BatchNorm stats moved off init by
    one train-mode step) and the same weights in the port's form."""
    cfg = dataclasses.replace(
        tiny_experiment.model, model="sasrec_fibinet", use_pallas=use_pallas,
        bilinear_type=btype, attn_num_layers=layers,
        tower_dtype="float32" if precision == "float32" else "compute",
    )
    train = dataclasses.replace(tiny_experiment.train, compute_dtype=precision)
    exp = tiny_experiment.replace(model=cfg, train=train)
    module, params, state = jax_build_model(tiny_feature_map, cfg, jax.random.key(0))
    batch = make_batch(np.random.default_rng(3), 64)
    _, state = module.apply(
        params, state, tiny_feature_map, cfg, batch, train=True, rng=jax.random.key(1)
    )
    pexp = pt_serialize.from_json(jax_serialize.to_json(exp))
    pparams, pstate = jax_bridge.params_from_jax(
        to_np(params), to_np(state), pt_build_fm(pexp.dataset), pexp.model
    )
    return exp, module, params, state, pexp, pparams, pstate


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_model_logits_match_jax(tiny_experiment, tiny_feature_map, use_pallas, precision):
    """Eval logits, port against JAX, the JAX params moved through
    jax_bridge. fp32: rtol 1e-4 / atol 1e-5 (summation order). bf16: atol
    1e-2 on logits of magnitude ~0.2 (1e-3 measured) and rank correlation
    above 0.995: XLA and PyTorch round the bf16 trunk, tower and (with
    use_pallas off) the bf16 LayerNorm and softmax at different places."""
    from tests.test_torch_predictor import rank_corr

    layers = 2 if use_pallas else 1
    exp, module, params, state, pexp, pparams, pstate = _setup(
        tiny_experiment, tiny_feature_map, precision=precision, use_pallas=use_pallas,
        layers=layers,
    )
    batch = make_batch(np.random.default_rng(7), 23)
    batch["item_seq"][0] = 0  # an all-pad history
    jd, td = DTYPES[precision]
    want, _ = module.apply(params, state, tiny_feature_map, exp.model,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           train=False, compute_dtype=jd)
    pm = get_model("sasrec_fibinet")
    assert pm.SEQ_POOLING == "attention" and len(pparams["trunk"]["attn"]["item_seq"]["blocks"]) == layers
    launches = enc.encode_fwd.launches
    got, _ = pm.apply(pparams, pstate, pt_build_fm(pexp.dataset), pexp.model,
                      {k: torch.from_numpy(v) for k, v in batch.items()}, compute_dtype=td)
    assert enc.encode_fwd.launches == launches
    want = np.asarray(want, np.float32)
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == (23,)
    if precision == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
        assert rank_corr(got, want) > 0.995


def _item_store(batch):
    from ctr_recommendation_tpu_torch.data import ItemStore

    mm = np.zeros((200, 24), np.float32)
    mm[batch["item_id"]] = batch["item_emb_d128"]
    return ItemStore.from_arrays(np.arange(200), mm)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("btype", ["all", "each"])
def test_predictor_matches_jax(tiny_experiment, tiny_feature_map, btype, precision):
    """The Predictor, fused (encoder + scoring) and unfused (encoder +
    interaction + torch tower) on device="cpu", against the JAX Predictor:
    the tests/test_torch_predictor.py bar (bf16 within 2e-2 and rank
    correlation above 0.995; fp32 rtol 1e-4 / atol 1e-5)."""
    from ctr_recommendation_tpu.data import ItemStore as JaxItemStore
    from ctr_recommendation_tpu.data import TableData as JaxTableData
    from tests.test_torch_predictor import rank_corr

    exp, _, params, state, pexp, pparams, pstate = _setup(
        tiny_experiment, tiny_feature_map, precision=precision, btype=btype
    )
    batch = make_batch(np.random.default_rng(4), 64)
    batch["item_seq"][:3] = 0
    cols = {k: v for k, v in batch.items() if k != "item_emb_d128"}
    store = _item_store(batch)
    jpred = JaxPredictor(exp, params, state, item_store=JaxItemStore(store.emb, store.known_mask))
    want = np.asarray(jpred(batch))
    want_table = jpred.score_table(JaxTableData(cols, 64), batch_size=24)
    fused = Predictor(pexp, pparams, pstate, device="cpu", item_store=store)
    unfused = Predictor(pexp, pparams, pstate, device="cpu", fold_bn=False, item_store=store)
    assert fused.use_fused and not unfused.use_fused
    launches = (enc.encode_fwd.launches, score_fwd.launches, interaction_fwd.launches)
    for pred in (fused, unfused):
        for got, ref in (
            (pred(batch).numpy(), want),
            (pred.score_table(TableData(cols, 64), batch_size=24), want_table),
        ):
            if precision == "float32":
                np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
            else:
                np.testing.assert_allclose(got, ref, atol=2e-2)
                assert rank_corr(got, ref) > 0.995
    assert (enc.encode_fwd.launches, score_fwd.launches, interaction_fwd.launches) == launches


def test_bridge_moves_the_encoder_blocks(tmp_path, tiny_experiment, tiny_feature_map):
    """params_from_jax checks the JAX tree against sasrec_fibinet.init's
    (two encoder blocks here), and the .npz round trip turns blocks/0/...
    back into a list."""
    _, _, params, state, pexp, pparams, _ = _setup(tiny_experiment, tiny_feature_map, layers=2)
    fm = pt_build_fm(pexp.dataset)
    path = str(tmp_path / "w.npz")
    jax_bridge.save(path, jax.device_get(params), jax.device_get(state))
    lparams, lstate = jax_bridge.load(path)
    assert isinstance(lparams["trunk"]["attn"]["item_seq"]["blocks"], list)
    again, _ = jax_bridge.params_from_jax(lparams, lstate, fm, pexp.model)
    blocks = again["trunk"]["attn"]["item_seq"]["blocks"]
    assert isinstance(blocks, list) and len(blocks) == 2
    flat = jax_bridge.flatten(pparams)
    assert "trunk/attn/item_seq/blocks/1/ffn2/w" in flat
    for k, v in jax_bridge.flatten(again).items():
        np.testing.assert_array_equal(v.numpy(), flat[k].numpy())
    lparams["trunk"]["attn"]["item_seq"]["blocks"] = blocks[:1]
    with pytest.raises(ValueError, match="tree mismatch"):
        jax_bridge.params_from_jax(lparams, lstate, fm, pexp.model)


def test_predict_cli_serves_sasrec(tmp_path, tiny_experiment, tiny_feature_map):
    """--model sasrec_fibinet --weights on the CPU writes a CSV equal to the
    same Predictor's score_table; a --model that contradicts the
    checkpoint's experiment.json is refused."""
    import pyarrow.parquet as pq

    from ctr_recommendation_tpu_torch.cli.predict import main
    from ctr_recommendation_tpu_torch.data import ItemStore
    from ctr_recommendation_tpu_torch.data.parquet import _pad_list_column
    from tests.test_torch_predictor import _read_csv, _tiny_split

    root = _tiny_split(tmp_path, tiny_experiment)
    _, _, params, state, pexp, pparams, pstate = _setup(tiny_experiment, tiny_feature_map)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    pt_serialize.save(pexp, str(ckpt / "experiment.json"))
    weights = str(tmp_path / "w.npz")
    jax_bridge.save(weights, jax.device_get(params), jax.device_get(state))
    out = tmp_path / "out"
    rc = main([
        "--data-root", root, "--checkpoint-dir", str(ckpt), "--model", "sasrec_fibinet",
        "--weights", weights, "--out-dir", str(out), "--batch-size", "64", "--device", "cpu",
    ])
    assert rc == 0
    ids, probs = _read_csv(out / "prediction_fibinet.csv")
    np.testing.assert_array_equal(ids, np.arange(1200))
    assert (out / "submission_fibinet.zip").exists()
    tbl = pq.read_table(f"{root}/test.parquet")
    cols = {k: tbl[k].to_numpy().astype(np.int32)
            for k in ("likes_level", "views_level", "item_id")}
    cols["item_seq"] = _pad_list_column(tbl["item_seq"], 8, 0)
    pred = Predictor(pexp, pparams, pstate, device="cpu",
                     item_store=ItemStore.from_parquet(f"{root}/item_info.parquet"))
    np.testing.assert_array_equal(probs, pred.score_table(TableData(cols, tbl.num_rows), 64))
    with pytest.raises(SystemExit):
        main(["--data-root", root, "--checkpoint-dir", str(ckpt), "--model", "mm_fibinet",
              "--weights", weights, "--device", "cpu"])


# ------------------------------------------------------- on the card only


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,heads,layers,b", [(128, 2, 1, 8192 + 37), (64, 4, 2, 4096 + 37)])
def test_encoder_kernel_matches_plain_on_the_card(e, heads, layers, b, dtype):
    """The kernel against its plain version at chip_smoke.py's bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the encoder kernel has no CPU mode")
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    td = DTYPES[dtype][1]
    x, amask, pad, ws, _, _, _ = chip_smoke.encoder_case(torch, td, b, e, heads, layers, seed=b)
    got = enc.encode_fwd(x, amask, *ws, num_heads=heads)
    want = enc.encode_fwd_plain(x, amask, *ws, num_heads=heads)
    torch.cuda.synchronize()
    err, rel_norm, ok = chip_smoke.check_encoder(torch, got, want, dtype)
    assert ok, (err, rel_norm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,heads,layers,b", [(128, 2, 1, 4096 + 37), (64, 4, 2, 4096 + 37)])
def test_dropout_forward_matches_plain_on_the_card(e, heads, layers, b, dtype):
    """The forward kernel with dropout (rate 0.1) against its plain version
    under the same seed, at chip_smoke.py's bars; rate 0 equals the eval
    launch bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the encoder kernel has no CPU mode")
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    td = DTYPES[dtype][1]
    x, amask, _, ws, _, _, _ = chip_smoke.encoder_case(torch, td, b, e, heads, layers, seed=b)
    seed = torch.tensor([b], dtype=torch.int64, device="cuda")
    got = enc.encode_fwd(x, amask, *ws, num_heads=heads, seed=seed, rate=0.1)
    want = enc.encode_fwd_plain(x, amask, *ws, num_heads=heads, seed=seed, rate=0.1)
    torch.cuda.synchronize()
    err, rel_norm, ok = chip_smoke.check_encoder(torch, got, want, dtype)
    assert ok, (err, rel_norm)
    assert torch.equal(enc.encode_fwd(x, amask, *ws, num_heads=heads, seed=seed, rate=0.0),
                       enc.encode_fwd(x, amask, *ws, num_heads=heads))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,heads,layers,b", [(128, 2, 1, 4096 + 37), (64, 4, 2, 4133)])
def test_encoder_backward_kernel_matches_plain_on_the_card(e, heads, layers, b, dtype, rate):
    """The backward kernel against its plain version at chip_smoke.py's
    bars, its repeat bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the encoder kernel has no CPU mode")
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    td = DTYPES[dtype][1]
    x, amask, pad, ws, _, _, _ = chip_smoke.encoder_case(torch, td, b, e, heads, layers, seed=b)
    g = chip_smoke.encoder_cotangent(torch, pad, e, b, td)
    seed = torch.tensor([b + 1], dtype=torch.int64, device="cuda")
    got = enc.encode_bwd(g, x, amask, *ws, num_heads=heads, seed=seed, rate=rate)
    again = enc.encode_bwd(g, x, amask, *ws, num_heads=heads, seed=seed, rate=rate)
    want = enc.encode_bwd_plain(g, x, amask, *ws, num_heads=heads, seed=seed, rate=rate)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    err, rel_norm, gate_free, bad = chip_smoke.check_encoder_bwd(torch, got, want, dtype)
    assert not bad, (err, rel_norm, gate_free, bad)
