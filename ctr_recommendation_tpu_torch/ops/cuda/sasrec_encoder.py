"""Kernels 5 and 6: the SASRec encoder forward (csrc/sasrec_encoder.cu) and
backward (csrc/sasrec_encoder_bwd.cu).

Replace ctr_recommendation_tpu/ops/pallas/sasrec_encoder.py::_fwd_kernel
(:220) and ::_bwd_kernel (:238), reached through ``fused_encode`` (:621),
whose ``jax.custom_vjp`` becomes the ``FusedEncoder`` autograd Function here.

Bound on an H100: operations, both ways. At B=8192, S=20, E=128, one layer,
the forward is 66.1 GFLOP against ~85 MB moved; at B=4096 the backward
(which recomputes the forward and does two products per weight) is 99.2
GFLOP against ~64 MB. A block owns whole histories (attention needs all S
steps of one) and keeps their fp32 stream in shared memory for every layer;
the weights (384 KB a layer in bf16, more than a block's 227 KB) are staged
from L2 one column block at a time. fp32 FMA on the CUDA cores.

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
rounded once to x's dtype; the 12 weight gradients are fp32.

Dropout (``attn_dropout`` on the attention branch's output a1, branch 0, and
the FFN's output f2, branch 1, before each residual add) comes from a
counter-based generator, Philox4x32-10, keyed by (seed, global token
b*S + s, column, layer, branch): ``dropout_mask`` here and
``dropout_keep`` in csrc/common.cuh draw the same bits, so the kernels and
the plain versions apply the same masks, and the forward and backward may
tile the batch differently. The TPU kernel seeds its PRNG per grid step
instead: same Bernoulli statistics, another realization (docs/PARITY.md).

``encode_fwd`` and ``encode_bwd`` are the wrappers: on a CUDA tensor each
launches its kernel (or raises), on a CPU tensor it runs its plain version.
Their ``launches`` attributes count kernel launches (the backward counts two
a call: the kernel and the reduction of its per-block weight-gradient
partials). The kernels' envelope: 1 <= S <= 32, E % 32 == 0, 32 <= E <= 128,
E % H == 0, L >= 1, bf16 or fp32, 0 <= rate < 1.
"""

from __future__ import annotations

import ctypes

import torch

from ctr_recommendation_tpu_torch.ops.attention import NEG_INF
from ctr_recommendation_tpu_torch.ops.cuda import build
from ctr_recommendation_tpu_torch.ops.cuda.interaction import check_kernel_args

MAX_S = 32
LN_EPS = 1e-6
WEIGHT_NAMES = (
    "qkv_w", "qkv_b", "proj_w", "proj_b", "ln1_s", "ln1_b",
    "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b", "ln2_s", "ln2_b",
)
_MATRICES = ("qkv_w", "proj_w", "ffn1_w", "ffn2_w")

# Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3")
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) words of the 64-bit product of the constant a and b (both
    below 2^32), in int64: b is split into 16-bit halves so that no partial
    product reaches 2^63."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    mid = p_hi + (p_lo >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32(ctr, key):
    """Philox4x32-10 on uint32 words held in int64: ctr a sequence of four
    tensors (or ints), key of two; returns the four output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_mask(seed, n_tokens: int, e: int, layer: int, branch: int, rate: float):
    """Keep mask (n_tokens, e) bool of dropout site (layer, branch): element
    (t, c) is Philox4x32-10 word c % 4 of counter (t, c // 4, 2 layer +
    branch, 0) under key (seed's low, high 32 bits); u = (word >> 8) 2^-24,
    the TPU kernel's top-24-bit rule, and the element is kept iff u >= rate
    (compared in fp32). ``seed`` is an int64 tensor (1,) on the device of
    the result, or an int; nothing is read back to the host."""
    seed = torch.as_tensor(seed, dtype=torch.int64).reshape(-1)[:1]
    dev = seed.device
    t = torch.arange(n_tokens, dtype=torch.int64, device=dev)[:, None]
    q = torch.arange(e // 4, dtype=torch.int64, device=dev)[None, :]
    words = philox4x32(
        (t, q, torch.full((), 2 * layer + branch, dtype=torch.int64, device=dev),
         torch.zeros((), dtype=torch.int64, device=dev)),
        (seed & _U32, (seed >> 32) & _U32),
    )
    w = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(n_tokens, e)
    u = (w >> 8).to(torch.float32) * 2.0**-24
    return u >= torch.tensor(rate, dtype=torch.float32, device=dev)


def _dropout(a, seed, layer, branch, rate):
    """a (N, E) fp32 with the kernel's dropout applied: kept elements scaled
    by fp32(1 / (1 - rate)), the rest 0; a unchanged at rate 0."""
    if rate <= 0.0:
        return a
    keep = dropout_mask(seed, a.shape[0], a.shape[1], layer, branch, rate)
    return torch.where(keep, a * (1.0 / (1.0 - rate)), torch.zeros((), device=a.device))


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


def _ln_fwd(h, scale, bias):
    """fp32 LayerNorm -> (out, xhat, rstd), as the TPU kernel's ``_ln_fwd``."""
    m = h.mean(-1, keepdim=True)
    r = torch.rsqrt((h - m).square().mean(-1, keepdim=True) + LN_EPS)
    xhat = (h - m) * r
    return xhat * scale + bias, xhat, r


def _ln_bwd(g, xhat, r, scale):
    """dx of y = xhat * scale + bias, with (dscale, dbias) summed over rows."""
    dxhat = g * scale
    dx = r * (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, (g * xhat).sum(0), g.sum(0)


def _heads(t, b, s, h):
    """(B*S, H*D) -> (B, H, S, D)."""
    return t.reshape(b, s, h, -1).transpose(1, 2)


def _merge(t):
    """(B, H, S, D) -> (B*S, H*D)."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b * s, h * d)


def _layer_fwd(h, mask, w, li, cd, num_heads, b, s, seed, rate):
    """One pre-LN block on the fp32 stream h (B*S, E) at the kernels'
    rounding points -> (new h, the residues the backward needs)."""
    (qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
     ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b) = (t[li] for t in w)
    e = h.shape[1]
    d = e // num_heads

    def mm(a, wt):  # operands rounded to cd, fp32 accumulation
        return a.to(cd).float() @ wt.to(cd).float()

    hn1, xhat1, r1 = _ln_fwd(h, ln1_s, ln1_b)
    qkv = mm(hn1, qkv_w) + qkv_b
    q, k, v = (_heads(t, b, s, num_heads) for t in qkv.split(e, -1))
    p = torch.softmax(q @ k.transpose(-1, -2) * (1.0 / d**0.5) + mask, dim=-1)
    ao = _merge(p @ v)
    h1 = h + _dropout(mm(ao, proj_w) + proj_b, seed, li, 0, rate)
    hn2, xhat2, r2 = _ln_fwd(h1, ln2_s, ln2_b)
    z1 = mm(hn2, ffn1_w) + ffn1_b
    f1 = torch.relu(z1)
    h2 = h1 + _dropout(mm(f1, ffn2_w) + ffn2_b, seed, li, 1, rate)
    return h2, dict(xhat1=xhat1, r1=r1, qkv=qkv, p=p, ao=ao, xhat2=xhat2, r2=r2, z1=z1)


def encode_fwd_plain(
    x, amask, qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
    ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b, *, num_heads, seed=None, rate=0.0,
):
    """Plain PyTorch version at the kernel's rounding points: x (B, S, E) in
    cd, amask (B, S) fp32 additive -> (B, S, E) in cd. With ``rate`` > 0 the
    dropout masks of ``dropout_mask`` under ``seed`` multiply a1 and f2."""
    w = (qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b, ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b)
    b, s, e = x.shape
    mask = amask.float()[:, None, None, :]
    h = x.float().reshape(b * s, e)
    for li in range(qkv_w.shape[0]):
        h, _ = _layer_fwd(h, mask, w, li, x.dtype, num_heads, b, s, seed, rate)
    return h.reshape(b, s, e).to(x.dtype)


def encode_bwd_plain(g, x, amask, *weights, num_heads, seed=None, rate=0.0,
                     fp32_operands=False):
    """Plain PyTorch version of the backward: the hand-derived VJP of the TPU
    kernel's ``_bwd_kernel`` (:238-351, with ``_attn_bwd`` :108-136 and
    ``_ln_bwd`` :70-76) at its rounding points, not autograd. g and x
    (B, S, E) in cd, amask (B, S) fp32, the 12 stacked weights -> (dx in cd,
    the 12 weight gradients fp32, summed over the batch).

    ``fp32_operands=True`` leaves every operand of the backward's products in
    fp32 instead of rounding it to cd: a wrong backward that the bf16 norm bar
    of the checks must reject. In fp32 the two agree."""
    cd = x.dtype
    b, s, e = x.shape
    d = e // num_heads
    inv = 1.0 / d**0.5

    def rc(t):  # an operand of a backward product
        return t.float() if fp32_operands else t.to(cd).float()

    mask = amask.float()[:, None, None, :]
    h = x.float().reshape(b * s, e)
    saved = []
    for li in range(weights[0].shape[0]):
        h, res = _layer_fwd(h, mask, weights, li, cd, num_heads, b, s, seed, rate)
        saved.append(res)

    grads = [torch.zeros(t.shape, dtype=torch.float32, device=x.device) for t in weights]
    (dqkv_w, dqkv_b, dproj_w, dproj_b, dln1_s, dln1_b,
     dffn1_w, dffn1_b, dffn2_w, dffn2_b, dln2_s, dln2_b) = grads
    dh = g.float().reshape(b * s, e)
    for li in reversed(range(weights[0].shape[0])):
        (qkv_w, _, proj_w, _, ln1_s, ln1_b, ffn1_w, _, ffn2_w, _, ln2_s, ln2_b) = (
            t[li] for t in weights)
        res = saved[li]
        # FFN branch
        hn2 = res["xhat2"] * ln2_s + ln2_b
        f1 = torch.relu(res["z1"])
        df2 = _dropout(dh, seed, li, 1, rate)
        dffn2_w[li] = rc(f1).T @ rc(df2)
        dffn2_b[li] = df2.sum(0)
        dz1 = (rc(df2) @ rc(ffn2_w).T) * (f1 > 0.0)
        dffn1_w[li] = rc(hn2).T @ rc(dz1)
        dffn1_b[li] = dz1.sum(0)
        dx2, dln2_s[li], dln2_b[li] = _ln_bwd(rc(dz1) @ rc(ffn1_w).T, res["xhat2"], res["r2"],
                                              ln2_s)
        dh1 = dh + dx2
        # attention branch
        hn1 = res["xhat1"] * ln1_s + ln1_b
        da1 = _dropout(dh1, seed, li, 0, rate)
        dproj_w[li] = rc(res["ao"]).T @ rc(da1)
        dproj_b[li] = da1.sum(0)
        dao = _heads(rc(da1) @ rc(proj_w).T, b, s, num_heads)
        q, k, v = (_heads(t, b, s, num_heads) for t in res["qkv"].split(e, -1))
        p = res["p"]
        dp = dao @ v.transpose(-1, -2)
        dlog = p * (dp - (dp * p).sum(-1, keepdim=True)) * inv
        dqkv = torch.cat([_merge(dlog @ k), _merge(dlog.transpose(-1, -2) @ q),
                          _merge(p.transpose(-1, -2) @ dao)], dim=-1)
        dqkv_w[li] = rc(hn1).T @ rc(dqkv)
        dqkv_b[li] = dqkv.sum(0)
        dx1, dln1_s[li], dln1_b[li] = _ln_bwd(rc(dqkv) @ rc(qkv_w).T, res["xhat1"], res["r1"],
                                              ln1_s)
        dh = dh1 + dx1
    return (dh.reshape(b, s, e).to(cd), *grads)


_LIB = None
_BWD = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("sasrec_encoder")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sasrec_encode_fwd.argtypes = [vp] * 16 + [i] * 5 + [f] * 3 + [i, vp]
        lib.sasrec_encode_fwd.restype = i
        lib.sasrec_encode_tile.argtypes = [i, i]
        lib.sasrec_encode_tile.restype = i
        _LIB = lib
    return _LIB


def _bwd_lib():
    global _BWD
    if _BWD is None:
        lib = build.load("sasrec_encoder_bwd")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sasrec_encode_bwd.argtypes = [vp] * 20 + [i] * 5 + [f] * 3 + [i] * 3 + [vp]
        lib.sasrec_encode_bwd.restype = i
        lib.sasrec_encode_bwd_tile.argtypes = [i, i, i]
        lib.sasrec_encode_bwd_tile.restype = i
        _BWD = lib
    return _BWD


def _check_dropout(seed, rate) -> None:
    """The dropout arguments, on any device: 0 <= rate < 1, and a seed when
    rate > 0."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("dropout (rate > 0) needs a seed: an int64 tensor of shape (1,)")


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
    if not (1 <= s <= MAX_S and e % 32 == 0 and 32 <= e <= 128 and num_heads >= 1
            and e % num_heads == 0 and layers >= 1):
        raise ValueError(
            f"outside the kernel's envelope (1 <= S <= {MAX_S}, E % 32 == 0, 32 <= E <= 128, "
            f"E % H == 0, L >= 1): S={s}, E={e}, H={num_heads}, L={layers}"
        )
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


def _seed_ptr(seed, rate) -> int | None:
    return seed.data_ptr() if rate > 0.0 else None


def encode_fwd(x, amask, *weights, num_heads, seed=None, rate=0.0):
    """x (B, S, E) bf16/fp32, the pos-embedded history with pad rows zeroed;
    amask (B, S) fp32, -1e9 at pad keys; the 12 operands of
    ``stack_weights``; with ``rate`` > 0 the dropout seed, an int64 tensor
    (1,) on x's device -> the encoded history (B, S, E) in x's dtype (pad
    rows hold what the layers left there)."""
    _check_dropout(seed, rate)
    if x.device.type == "cpu":
        return encode_fwd_plain(x, amask, *weights, num_heads=num_heads, seed=seed, rate=rate)
    b, s, e, layers = _check_envelope("encode_fwd", x, amask, weights, num_heads, seed, rate)
    out = torch.empty_like(x)
    if b == 0:
        return out
    lib = _lib()
    if lib.sasrec_encode_tile(s, e) < 1:
        raise ValueError(f"encode_fwd: one history does not fit a block at S={s}, E={e}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.sasrec_encode_fwd(
        x.data_ptr(), amask.data_ptr(), *(t.data_ptr() for t in weights), _seed_ptr(seed, rate),
        out.data_ptr(), b, s, e, num_heads, layers, 1.0 / (e // num_heads) ** 0.5,
        rate, 1.0 / (1.0 - rate), int(x.dtype == torch.bfloat16), stream,
    )
    build.check(rc, "encode_fwd")
    encode_fwd.launches += 1
    return out


encode_fwd.launches = 0


def encode_bwd(g, x, amask, *weights, num_heads, seed=None, rate=0.0):
    """g and x (B, S, E) in the compute dtype (g the cotangent of
    ``encode_fwd``'s output, x its input), amask (B, S), the 12 operands of
    ``stack_weights`` and the forward's seed and rate -> (dx in x's dtype,
    the 12 weight gradients fp32 in the shapes of the weights)."""
    _check_dropout(seed, rate)
    if x.device.type == "cpu":
        return encode_bwd_plain(g, x, amask, *weights, num_heads=num_heads, seed=seed,
                                rate=rate)
    b, s, e, layers = _check_envelope("encode_bwd", x, amask, weights, num_heads, seed, rate)
    if tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected {tuple(x.shape)}")
    check_kernel_args({"g": (g, None)}, x.dtype, x.device)
    sizes = [t.numel() for t in weights]  # the gradients, one after another
    out = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    if b > 0:
        lib = _bwd_lib()
        tb = lib.sasrec_encode_bwd_tile(s, e, num_heads)
        if tb < 1:
            raise ValueError(f"encode_bwd: one history does not fit a block at S={s}, E={e}")
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        grid = min(-(-b // tb), sms)
        stride = -(-sum(sizes) // 4) * 4
        rows = -(-tb * s // 4) * 4
        part = torch.empty(grid * stride, dtype=torch.float32, device=x.device)
        scratch = torch.empty(grid * layers * rows * e, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sasrec_encode_bwd(
            g.data_ptr(), x.data_ptr(), amask.data_ptr(), *(t.data_ptr() for t in weights),
            _seed_ptr(seed, rate), dx.data_ptr(), part.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, s, e, num_heads, layers, 1.0 / (e // num_heads) ** 0.5,
            rate, 1.0 / (1.0 - rate), int(x.dtype == torch.bfloat16), grid, stride, stream,
        )
        build.check(rc, "encode_bwd")
        encode_bwd.launches += 2  # the kernel and the partials' reduction
    else:
        out.zero_()
    return (dx, *(t.view(w.shape) for t, w in zip(torch.split(out, sizes), weights)))


encode_bwd.launches = 0


class FusedEncoder(torch.autograd.Function):
    """The encoder on the kernels both ways, as ``jax.custom_vjp`` wraps the
    TPU kernels: it takes the fp32 master weights and returns fp32 weight
    gradients; the four matrices are cast to the compute dtype inside, and
    x (not the output) is kept for the backward, which recomputes the rest
    and redraws the dropout masks from the same seed."""

    @staticmethod
    def forward(ctx, x, amask, seed, rate, num_heads, *weights):
        ctx.save_for_backward(x, amask, seed, *weights)
        ctx.rate, ctx.num_heads = rate, num_heads
        return encode_fwd(x, amask, *cast_matrices(weights, x.dtype), num_heads=num_heads,
                          seed=seed, rate=rate)

    @staticmethod
    def backward(ctx, g):
        x, amask, seed, *weights = ctx.saved_tensors
        dx, *dws = encode_bwd(
            g.to(x.dtype).contiguous(), x, amask, *cast_matrices(weights, x.dtype),
            num_heads=ctx.num_heads, seed=seed, rate=ctx.rate,
        )
        return (dx, None, None, None, None, *dws)


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
) -> torch.Tensor:
    """The JAX package's ``fused_encode``: seq_emb (B, S, E), seq_ids (B, S)
    -> encoded (B, S, E) in seq_emb's dtype (bf16 or fp32), pad rows zero.
    Differentiable w.r.t. seq_emb and every encoder parameter (pos_emb
    through the plain add). Dropout is on only when ``train``,
    ``dropout_rate`` > 0 and a ``seed`` (int64 tensor (1,)) is given."""
    drop_on = train and dropout_rate > 0.0 and seed is not None
    x, amask, pad = encoder_inputs(params, seq_emb, seq_ids, pad_id)
    out = FusedEncoder.apply(
        x, amask, seed if drop_on else None, float(dropout_rate) if drop_on else 0.0, num_heads,
        *stack_weights(params, torch.float32),
    )
    return torch.where(pad[..., None], torch.zeros((), dtype=out.dtype, device=out.device), out)
