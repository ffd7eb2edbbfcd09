"""Kernels 5 and 6: the SASRec encoder forward (csrc/sasrec_encoder.cu) and
backward (csrc/sasrec_encoder_bwd.cu), token-major on the tensor cores.

Replace ctr_recommendation_tpu/ops/pallas/sasrec_encoder.py::_fwd_kernel
(:220) and ::_bwd_kernel (:238), reached through ``fused_encode`` (:621),
whose ``jax.custom_vjp`` becomes the ``FusedEncoder`` autograd Function here.

Bound on an H100: operations, both ways. At B=8192, S=20, E=128, one layer,
the forward is 66.1 GFLOP against ~85 MB moved; at B=4096 the backward
(which recomputes the forward and does two products per weight) is 99.2
GFLOP against ~64 MB. Each is a sequence of launches over all B*S tokens,
built from the blocks of ``encoder_blocks`` (the tile product with fused
epilogues on ``mma.sync``, LayerNorm, attention, column sums and their
fixed-order reduction), enqueued by one C call: ``fwd_launches(L)`` and
``bwd_launches(L)`` give the launches of one call.

Precision contract (the TPU kernels', ``sasrec_encoder.py:61-67``,
``:159-351``), kept by the kernels and by ``encode_fwd_plain`` /
``encode_bwd_plain``: the stream is fp32 (x upcast once, the output rounded
once to x's dtype cd); LayerNorm is fp32 with the biased variance and eps
1e-6; the four weight products take operands rounded to cd and accumulate
in fp32, biases fp32; attention is fp32 throughout (qkv is not rounded),
logits scaled by 1/sqrt(D) plus the additive fp32 mask (-1e9 at pad keys);
pad rows are not re-zeroed between layers (``fused_encode`` zeroes them on
output). The backward rounds the operands of every weight product and of
every transposed product to cd (hn2, f1, df2, dz1, ao, da1, dqkv, hn1 and
the weights); attention, softmax and LayerNorm backward run in fp32; dx is
rounded once to x's dtype; the 12 weight gradients are fp32, the bias
gradients sums of fp32 values.

Dropout (``attn_dropout`` on the attention branch's output a1, branch 0, and
the FFN's output f2, branch 1, before each residual add) comes from the
counter-based ``dropout_mask`` of ``encoder_blocks``, keyed by (seed, global
token, column, layer, branch), so the kernels and the plain versions apply
the same masks. The TPU kernel seeds its PRNG per grid step instead: same
Bernoulli statistics, another realization (docs/PARITY.md).

``encode_fwd`` and ``encode_bwd`` are the wrappers: on a CUDA tensor each
enqueues its kernels (or raises), on a CPU tensor it runs its plain version.
Their ``launches`` attributes count kernel launches. The kernels' envelope
(``fits``, one predicate for both directions): 1 <= S <= 128, E % 32 == 0,
E >= 32, E % H == 0, D = E/H a multiple of 4 up to 256, L >= 1, and the
attention's staged heads within a block's shared memory both ways (at
D = 64 up to S = 115, at D = 128 up to S = 83); bf16 or fp32, 0 <= rate
< 1. The kernels keep token-major intermediates in a workspace the wrapper
allocates, at E=128 in bf16: the forward's 3.5 KB a token, the backward's
4.5 KB a token a layer plus 4.8 KB a token and ~70 MB of weight-gradient
partials; all scale with E (the backward's softmax, B H S^2 floats, with
S^2).
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.ops.attention import NEG_INF
from ctr_recommendation_tpu_torch.ops.cuda import build
from ctr_recommendation_tpu_torch.ops.cuda.encoder_blocks import (  # noqa: F401 (re-exported)
    MAX_D,
    MAX_S,
    MAX_SMEM,
    attn_bwd_smem,
    attn_fwd_smem,
    attention_bwd_plain,
    attention_fwd_plain,
    bwd_lib,
    check_dropout,
    column_sums_plain,
    dropout,
    dropout_args,
    dropout_mask,
    fwd_lib,
    is_bf16,
    layer_norm_bwd_plain,
    layer_norm_plain,
    philox4x32,
    product_plain,
    stream_of,
)
from ctr_recommendation_tpu_torch.ops.cuda.interaction import check_kernel_args

WEIGHT_NAMES = (
    "qkv_w", "qkv_b", "proj_w", "proj_b", "ln1_s", "ln1_b",
    "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b", "ln2_s", "ln2_b",
)
_MATRICES = ("qkv_w", "proj_w", "ffn1_w", "ffn2_w")


def fwd_launches(layers: int) -> int:
    """Kernel launches of one ``encode_fwd`` call: the upcast of x, then
    LN1, qkv, attention, proj, LN2, ffn1 and ffn2 a layer (dropout or not)."""
    return 1 + 7 * layers


def bwd_launches(layers: int) -> int:
    """Kernel launches of one ``encode_bwd`` call: the forward recomputed
    (1 + 7 L - 1: the last layer's ffn2 is not needed), the upcast of g,
    then 18 a layer in reverse: 8 products, 6 column sums, the attention
    backward, 2 LayerNorm backwards and the reduction of the layer's
    weight-gradient partials."""
    return 25 * layers + 1


def stack_weights(params: dict, dtype: torch.dtype) -> tuple:
    """The 12 stacked (L, ...) operands in the order of the TPU kernel's
    ``_stack_weights`` (WEIGHT_NAMES): the four matrices in ``dtype``, the
    biases and LayerNorm parameters fp32."""
    blocks = params["blocks"]
    leaves = {
        "qkv_w": [b["qkv"]["w"] for b in blocks], "qkv_b": [b["qkv"]["b"] for b in blocks],
        "proj_w": [b["proj"]["w"] for b in blocks], "proj_b": [b["proj"]["b"] for b in blocks],
        "ln1_s": [b["ln1_scale"] for b in blocks], "ln1_b": [b["ln1_bias"] for b in blocks],
        "ffn1_w": [b["ffn1"]["w"] for b in blocks], "ffn1_b": [b["ffn1"]["b"] for b in blocks],
        "ffn2_w": [b["ffn2"]["w"] for b in blocks], "ffn2_b": [b["ffn2"]["b"] for b in blocks],
        "ln2_s": [b["ln2_scale"] for b in blocks], "ln2_b": [b["ln2_bias"] for b in blocks],
    }
    return tuple(
        torch.stack(leaves[n]).to(dtype if n in _MATRICES else torch.float32).contiguous()
        for n in WEIGHT_NAMES
    )


def cast_matrices(weights, dtype: torch.dtype) -> tuple:
    """The 12 stacked operands with the four matrices cast to ``dtype``."""
    return tuple(
        t.to(dtype).contiguous() if n in _MATRICES else t for n, t in zip(WEIGHT_NAMES, weights)
    )


def _layer_fwd(h, amask, w, li, cd, num_heads, seed, rate, acc=torch.float64, token0=0):
    """One pre-LN block on the fp32 stream h (B*S, E), composed of the
    plain blocks at the kernels' rounding points (products accumulated in
    ``acc``) -> (new h, the residues the backward needs, the products'
    operands kept in fp32)."""
    (qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
     ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b) = (t[li] for t in w)
    drop = dict(seed=seed, rate=rate, layer=li, acc=acc, token0=token0)
    hn1, xhat1, r1 = layer_norm_plain(h, ln1_s, ln1_b, torch.float32, residues=True)
    qkv = product_plain(hn1.to(cd), qkv_w.to(cd), "nn", "bias", bias=qkv_b, acc=acc)
    ao, p = attention_fwd_plain(qkv, amask, num_heads, torch.float32)
    h1 = product_plain(ao.to(cd), proj_w.to(cd), "nn", "residual", bias=proj_b, aux=h, branch=0,
                       **drop)
    hn2, xhat2, r2 = layer_norm_plain(h1, ln2_s, ln2_b, torch.float32, residues=True)
    f1 = product_plain(hn2.to(cd), ffn1_w.to(cd), "nn", "relu", bias=ffn1_b,
                       out_dtype=torch.float32, acc=acc)
    h2 = product_plain(f1.to(cd), ffn2_w.to(cd), "nn", "residual", bias=ffn2_b, aux=h1, branch=1,
                       **drop)
    return h2, dict(hn1=hn1, xhat1=xhat1, r1=r1, qkv=qkv, p=p, ao=ao, hn2=hn2, xhat2=xhat2,
                    r2=r2, f1=f1)


def encode_fwd_plain(
    x, amask, qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
    ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b, *, num_heads, seed=None, rate=0.0, token0=0,
):
    """Plain PyTorch version at the kernel's rounding points, composed of
    the plain blocks: x (B, S, E) in cd, amask (B, S) fp32 additive ->
    (B, S, E) in cd. With ``rate`` > 0 the dropout masks of ``dropout_mask``
    under ``seed`` (tokens counted from ``token0``) multiply a1 and f2."""
    w = (qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b, ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b)
    b, s, e = x.shape
    h = x.float().reshape(b * s, e)
    for li in range(qkv_w.shape[0]):
        h, _ = _layer_fwd(h, amask, w, li, x.dtype, num_heads, seed, rate, token0=token0)
    return h.reshape(b, s, e).to(x.dtype)


def encode_bwd_plain(g, x, amask, *weights, num_heads, seed=None, rate=0.0,
                     fp32_operands=False, acc=torch.float64, token0=0):
    """Plain PyTorch version of the backward: the hand-derived VJP of the TPU
    kernel's ``_bwd_kernel`` (:238-351, with ``_attn_bwd`` :108-136 and
    ``_ln_bwd`` :70-76) at its rounding points, not autograd, composed of
    the plain blocks. g and x (B, S, E) in cd, amask (B, S) fp32, the 12
    stacked weights -> (dx in cd, the 12 weight gradients fp32, summed over
    the batch).

    ``fp32_operands=True`` leaves every operand of the backward's products in
    fp32 instead of rounding it to cd: a wrong backward that the bf16 norm bar
    of the checks must reject. In fp32 the two agree. ``acc`` is the
    products' accumulation dtype (``product_plain``)."""
    cd = x.dtype
    b, s, e = x.shape

    def rc(t):  # an operand of a backward product
        return t.float() if fp32_operands else t.to(cd)

    h = x.float().reshape(b * s, e)
    saved = []
    for li in range(weights[0].shape[0]):
        h, res = _layer_fwd(h, amask, weights, li, cd, num_heads, seed, rate, acc, token0)
        saved.append(res)

    grads = [torch.zeros(t.shape, dtype=torch.float32, device=x.device) for t in weights]
    (dqkv_w, dqkv_b, dproj_w, dproj_b, dln1_s, dln1_b,
     dffn1_w, dffn1_b, dffn2_w, dffn2_b, dln2_s, dln2_b) = grads
    dh = g.float().reshape(b * s, e)
    for li in reversed(range(weights[0].shape[0])):
        qkv_w, _, proj_w, _, ln1_s, _, ffn1_w, _, ffn2_w, _, ln2_s, _ = (t[li] for t in weights)
        res = saved[li]
        # FFN branch
        df2 = dropout(dh, seed, li, 1, rate, token0)
        dffn2_w[li] = product_plain(rc(res["f1"]), rc(df2), "tn", acc=acc)
        dffn2_b[li] = column_sums_plain(df2)[0]
        dz1, _ = product_plain(rc(df2), rc(ffn2_w), "nt", "gate", aux=res["f1"],
                               acc=acc)
        dffn1_w[li] = product_plain(rc(res["hn2"]), rc(dz1), "tn", acc=acc)
        dffn1_b[li] = column_sums_plain(dz1)[0]
        dn2 = product_plain(rc(dz1), rc(ffn1_w), "nt", acc=acc)
        ds, db = column_sums_plain(dn2, "ln", x=res["xhat2"])
        dln2_s[li], dln2_b[li] = ds[0], db[0]
        dh = layer_norm_bwd_plain(dn2, res["xhat2"], res["r2"], ln2_s, dh)
        # attention branch
        da1 = dropout(dh, seed, li, 0, rate, token0)
        dproj_w[li] = product_plain(rc(res["ao"]), rc(da1), "tn", acc=acc)
        dproj_b[li] = column_sums_plain(da1)[0]
        dao = product_plain(rc(da1), rc(proj_w), "nt", acc=acc)
        dqkv, _ = attention_bwd_plain(res["qkv"], res["p"], dao, cd)
        dqkv_w[li] = product_plain(rc(res["hn1"]), rc(dqkv), "tn", acc=acc)
        dqkv_b[li] = column_sums_plain(dqkv)[0]
        dn1 = product_plain(rc(dqkv), rc(qkv_w), "nt", acc=acc)
        ds, db = column_sums_plain(dn1, "ln", x=res["xhat1"])
        dln1_s[li], dln1_b[li] = ds[0], db[0]
        dh = layer_norm_bwd_plain(dn1, res["xhat1"], res["r1"], ln1_s, dh)
    return (dh.reshape(b, s, e).to(cd), *grads)


def fits(s: int, e: int, num_heads: int, layers: int) -> bool:
    """Whether the kernels take (S, E, H, L), both ways: a pure function of
    the shapes, the C ``sasrec_encoder_fits`` (``in_envelope``) in Python."""
    if not (1 <= s <= MAX_S and e % 32 == 0 and e >= 32 and num_heads >= 1
            and e % num_heads == 0 and layers >= 1):
        return False
    d = e // num_heads
    return (d % 4 == 0 and d <= MAX_D and attn_fwd_smem(s, d) <= MAX_SMEM
            and attn_bwd_smem(s, d) <= MAX_SMEM)


def check_envelope(s: int, e: int, num_heads: int, layers: int) -> None:
    """Raise unless the kernels take (S, E, H, L) (``fits``)."""
    if not fits(s, e, num_heads, layers):
        raise ValueError(
            f"outside the kernels' envelope (1 <= S <= {MAX_S}, E % 32 == 0, E >= 32, "
            f"E % H == 0, E/H % 4 == 0, E/H <= {MAX_D}, L >= 1, the attention's shared memory "
            f"both ways <= {MAX_SMEM} bytes): S={s}, E={e}, H={num_heads}, L={layers}"
        )


def _check_envelope(what, x, amask, weights, num_heads, seed, rate):
    """Device, dtype, envelope and shapes of the kernels' operands (CUDA)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    if len(weights) != len(WEIGHT_NAMES):
        raise ValueError(f"expected {len(WEIGHT_NAMES)} stacked weights, got {len(weights)}")
    b, s, e = x.shape
    layers = weights[0].shape[0]
    check_envelope(s, e, num_heads, layers)
    want = {
        "qkv_w": (layers, e, 3 * e), "qkv_b": (layers, 3 * e), "proj_w": (layers, e, e),
        "proj_b": (layers, e), "ln1_s": (layers, e), "ln1_b": (layers, e),
        "ffn1_w": (layers, e, 4 * e), "ffn1_b": (layers, 4 * e), "ffn2_w": (layers, 4 * e, e),
        "ffn2_b": (layers, e), "ln2_s": (layers, e), "ln2_b": (layers, e),
    }
    for name, t in zip(WEIGHT_NAMES, weights):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]}")
    if tuple(amask.shape) != (b, s):
        raise ValueError(f"amask has shape {tuple(amask.shape)}, expected {(b, s)}")
    f32 = torch.float32
    tensors = {"x": (x, None), "amask": (amask, f32),
               **{n: (t, None if n in _MATRICES else f32) for n, t in zip(WEIGHT_NAMES, weights)}}
    if rate > 0.0:
        if tuple(seed.shape) != (1,):
            raise ValueError(f"the dropout seed has shape {tuple(seed.shape)}, expected (1,)")
        tensors["seed"] = (seed, torch.int64)
    check_kernel_args(tensors, x.dtype, x.device)
    return b, s, e, layers


def _workspace(nbytes: int, device):
    if nbytes == 0:
        raise ValueError("outside the kernels' envelope")
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def encode_fwd(x, amask, *weights, num_heads, seed=None, rate=0.0, token0=0):
    """x (B, S, E) bf16/fp32, the pos-embedded history with pad rows zeroed;
    amask (B, S) fp32, -1e9 at pad keys; the 12 operands of
    ``stack_weights``; with ``rate`` > 0 the dropout seed, an int64 tensor
    (1,) on x's device, and ``token0`` the global token of row 0 -> the
    encoded history (B, S, E) in x's dtype (pad rows hold what the layers
    left there)."""
    check_dropout(seed, rate)
    if x.device.type == "cpu":
        return encode_fwd_plain(x, amask, *weights, num_heads=num_heads, seed=seed, rate=rate,
                                token0=token0)
    b, s, e, layers = _check_envelope("encode_fwd", x, amask, weights, num_heads, seed, rate)
    out = torch.empty_like(x)
    if b == 0:
        return out
    lib = fwd_lib()
    ws = _workspace(lib.sasrec_encode_fwd_workspace(b, s, e, is_bf16(x)), x.device)
    seed_ptr, *drop = dropout_args(seed, rate, token0)
    rc = lib.sasrec_encode_fwd(
        x.data_ptr(), amask.data_ptr(), *(t.data_ptr() for t in weights), seed_ptr,
        out.data_ptr(), ws.data_ptr(), b, s, e, num_heads, layers, 1.0 / (e // num_heads) ** 0.5,
        *drop, is_bf16(x), stream_of(x),
    )
    build.check(rc, "encode_fwd")
    encode_fwd.launches += fwd_launches(layers)
    return out


encode_fwd.launches = 0


def encode_bwd(g, x, amask, *weights, num_heads, seed=None, rate=0.0, token0=0):
    """g and x (B, S, E) in the compute dtype (g the cotangent of
    ``encode_fwd``'s output, x its input), amask (B, S), the 12 operands of
    ``stack_weights`` and the forward's seed, rate and token0 -> (dx in x's
    dtype, the 12 weight gradients fp32 in the shapes of the weights)."""
    check_dropout(seed, rate)
    if x.device.type == "cpu":
        return encode_bwd_plain(g, x, amask, *weights, num_heads=num_heads, seed=seed,
                                rate=rate, token0=token0)
    b, s, e, layers = _check_envelope("encode_bwd", x, amask, weights, num_heads, seed, rate)
    if tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected {tuple(x.shape)}")
    check_kernel_args({"g": (g, None)}, x.dtype, x.device)
    sizes = [t.numel() for t in weights]  # the gradients, one after another
    out = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    if b > 0:
        lib = bwd_lib()
        ws = _workspace(lib.sasrec_encode_bwd_workspace(b, s, e, num_heads, layers, is_bf16(x)),
                        x.device)
        seed_ptr, *drop = dropout_args(seed, rate, token0)
        rc = lib.sasrec_encode_bwd(
            g.data_ptr(), x.data_ptr(), amask.data_ptr(), *(t.data_ptr() for t in weights),
            seed_ptr, dx.data_ptr(), out.data_ptr(), ws.data_ptr(), b, s, e, num_heads, layers,
            1.0 / (e // num_heads) ** 0.5, *drop, is_bf16(x), stream_of(x),
        )
        build.check(rc, "encode_bwd")
        encode_bwd.launches += bwd_launches(layers)
    else:
        out.zero_()
    return (dx, *(t.view(w.shape) for t, w in zip(torch.split(out, sizes), weights)))


encode_bwd.launches = 0


class FusedEncoder(torch.autograd.Function):
    """The encoder on the kernels both ways, as ``jax.custom_vjp`` wraps the
    TPU kernels: it takes the fp32 master weights and returns fp32 weight
    gradients; the four matrices are cast to the compute dtype inside, and
    x (not the output) is kept for the backward, which recomputes the rest
    and redraws the dropout masks from the same seed and token0."""

    @staticmethod
    def forward(ctx, x, amask, seed, rate, num_heads, token0, *weights):
        ctx.save_for_backward(x, amask, seed, *weights)
        ctx.rate, ctx.num_heads, ctx.token0 = rate, num_heads, token0
        return encode_fwd(x, amask, *cast_matrices(weights, x.dtype), num_heads=num_heads,
                          seed=seed, rate=rate, token0=token0)

    @staticmethod
    def backward(ctx, g):
        x, amask, seed, *weights = ctx.saved_tensors
        dx, *dws = encode_bwd(
            g.to(x.dtype).contiguous(), x, amask, *cast_matrices(weights, x.dtype),
            num_heads=ctx.num_heads, seed=seed, rate=ctx.rate, token0=ctx.token0,
        )
        return (dx, None, None, None, None, None, *dws)


def encoder_inputs(params: dict, seq_emb: torch.Tensor, seq_ids: torch.Tensor, pad_id: int = 0):
    """(x, amask, pad) as ``fused_encode`` feeds the kernel: the pos-emb add
    and the pad zeroing in the activation dtype, the additive fp32 mask."""
    s = seq_emb.shape[1]
    pad = seq_ids == pad_id
    x = seq_emb + params["pos_emb"][:s].to(seq_emb.dtype)
    x = torch.where(pad[..., None], torch.zeros((), dtype=x.dtype, device=x.device), x)
    amask = torch.zeros(pad.shape, dtype=torch.float32, device=pad.device).masked_fill(pad, NEG_INF)
    return x.contiguous(), amask, pad


def fused_encode(
    params: dict,
    seq_emb: torch.Tensor,
    seq_ids: torch.Tensor,
    *,
    num_heads: int,
    pad_id: int = 0,
    train: bool = False,
    dropout_rate: float = 0.0,
    seed: torch.Tensor | None = None,
    token0: int = 0,
) -> torch.Tensor:
    """The JAX package's ``fused_encode``: seq_emb (B, S, E), seq_ids (B, S)
    -> encoded (B, S, E) in seq_emb's dtype (bf16 or fp32), pad rows zero.
    Differentiable w.r.t. seq_emb and every encoder parameter (pos_emb
    through the plain add). Dropout is on only when ``train``,
    ``dropout_rate`` > 0 and a ``seed`` (int64 tensor (1,)) is given; its
    masks count tokens from ``token0`` (``dropout_mask``)."""
    drop_on = train and dropout_rate > 0.0 and seed is not None
    x, amask, pad = encoder_inputs(params, seq_emb, seq_ids, pad_id)
    out = FusedEncoder.apply(
        x, amask, seed if drop_on else None, float(dropout_rate) if drop_on else 0.0, num_heads,
        token0, *stack_weights(params, torch.float32),
    )
    return torch.where(pad[..., None], torch.zeros((), dtype=out.dtype, device=out.device), out)
