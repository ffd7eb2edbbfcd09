"""Kernels 5 and 6: the SASRec encoder forward (csrc/sasrec_encoder.cu) and
backward (csrc/sasrec_encoder_bwd.cu), token-major on the tensor cores.

Replace ctr_recommendation_tpu/ops/pallas/sasrec_encoder.py::_fwd_kernel
(:220) and ::_bwd_kernel (:238), reached through ``fused_encode`` (:621),
whose ``jax.custom_vjp`` becomes the ``FusedEncoder`` autograd Function here.

Bound on an H100: operations, both ways. At B=8192, S=20, E=128, one layer,
the forward is 66.1 GFLOP against ~85 MB moved; at B=4096 the backward
(which recomputes the forward and does two products per weight) is 99.2
GFLOP against ~64 MB. Each is a sequence of launches over a chunk's tokens,
built from the blocks of ``encoder_blocks`` (the tile product with fused
epilogues on ``mma.sync``, LayerNorm, attention, column sums and their
fixed-order reduction), enqueued by one C call a chunk: ``fwd_launches(L)``
and ``bwd_launches(L)`` give the launches of one chunk. The attention is the
streamed pair (keys walked in tiles on the tensor cores in 3xTF32, any S,
any head width), or the staged pair (fp32 on the CUDA cores) where
``encoder_blocks.attention_route`` says so.

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
(``fits``, one predicate for both directions): S >= 1, E >= 1, E % H == 0,
L >= 1, any head width D = E/H; bf16 or fp32, 0 <= rate < 1; any B,
and at a call S up to ``MAX_STREAM_S`` (``check_envelope``). Widths the
kernels do not take as they are (E % 32 != 0 or D % 4 != 0: SASRec's own
d = 50) run zero-padded (``padded_dims``: each head to Dp,
the stream to Ep = H Dp, a multiple of 32): the wrappers pad x and the
weights (``pad_weights``) and cut the output and the gradients back; the
kernels take LayerNorm's statistics over the true E and the softmax scale
of the true D, and key dropout by the true column, so the padded call
computes the unpadded function (``encode_fwd_plain(..., padded=True)``
runs the same padding through the plain blocks). The kernels keep
token-major intermediates in a workspace the wrapper allocates, at E=128
in bf16: the forward's 3.5 KB a token, the backward's 4.5 KB a token a
layer plus 4.8 KB a token and ~70 MB of weight-gradient partials; all
scale with E, and the staged backward's softmax (B H S^2 floats) with
S^2, where the streamed one keeps the fp32 output and (m, l) a query
instead (0.5 KB a token a layer at E = 128).

A call runs in chunks of whole rows (``plan_chunks``), as the TPU kernel's
grid walks the batch in blocks of ``block_b`` rows: each chunk is the launch
sequence above on its rows, within ``MAX_TOKENS`` tokens (the tile
product's grid rows) and ``WORKSPACE_BUDGET`` bytes of workspace (from
``fwd_workspace`` / ``bwd_workspace``, the C workspace functions in
Python), at its own token base for the dropout masks. One workspace, of the
first chunk's size, serves them all; padded widths are padded chunk by
chunk; the backward's last reduction of each layer adds a later chunk's
weight gradients to the earlier ones' (no launch more), in chunk order. The
plan is a function of the shapes alone, so a call's result stays a function
of its inputs, and a call that fits one chunk is the whole-call launch
sequence. ``call_launches`` gives a call's launches. The CPU plain versions
run through the same plan.
"""

from __future__ import annotations

import math

import torch

from ctr_recommendation_tpu_torch.ops.attention import NEG_INF
from ctr_recommendation_tpu_torch.ops.cuda import build
from ctr_recommendation_tpu_torch.ops.cuda.encoder_blocks import (  # noqa: F401 (re-exported)
    ATTN_BLOCK_ROWS,
    ATTN_TILE,
    MAX_S,
    MAX_SMEM,
    attn_bwd_smem,
    attn_fwd_smem,
    attention_bwd_plain,
    attention_bwd_streamed_plain,
    attention_fwd_plain,
    attention_fwd_streamed_plain,
    attention_route,
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
from ctr_recommendation_tpu_torch.utils.profiling import span

WEIGHT_NAMES = (
    "qkv_w", "qkv_b", "proj_w", "proj_b", "ln1_s", "ln1_b",
    "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b", "ln2_s", "ln2_b",
)
_MATRICES = ("qkv_w", "proj_w", "ffn1_w", "ffn2_w")
MAX_TOKENS = 65535 * 128  # B*S of one chunk: the tile product's grid rows (kMaxTokens)
MAX_STREAM_S = 65535 * ATTN_BLOCK_ROWS  # S: the streamed attention's grid rows (kMaxStreamS)
# Bytes of workspace one chunk of a call may take (plan_chunks). A constant:
# the plan, and so a call's result, is a function of the shapes alone.
WORKSPACE_BUDGET = 16 << 30
_SPLIT_BLOCKS = 264  # kSplitBlocks: the blocks a split weight-gradient sum aims at
_TILE = 128  # mma::BM = BN: the tile product's tile


def padded_dims(e: int, num_heads: int) -> tuple[int, int]:
    """(Ep, Dp): the widths the kernels run an encoder of width E and
    num_heads heads at, csrc/sasrec_encoder.cuh ``widths``. Each head is
    zero-padded to Dp, D = E / H rounded up to 32 / gcd(8, H), so that the
    heads fill a stream of Ep = H Dp columns, a multiple of 32 with 16-byte
    head rows. (E, D) itself when E % 32 == 0 and D % 4 == 0."""
    q = 32 // math.gcd(8, num_heads)
    dp = -(-(e // num_heads) // q) * q
    return num_heads * dp, dp


def _layouts(e: int, num_heads: int, device) -> dict:
    """The padded layout of each of the 12 stacked weights: for each of its
    dimensions after L, the padded index of every true one and the padded
    size. The stream and the FFN's hidden keep their real columns first;
    q, k, v (and the attention's output: proj_w's rows) keep head i's D
    columns at i Dp."""
    ep, dp = padded_dims(e, num_heads)
    d = e // num_heads
    c = torch.arange(e, device=device)
    stream, hid = (c, ep), (torch.arange(4 * e, device=device), 4 * ep)
    heads = ((c // d) * dp + c % d, ep)
    qkv = (torch.cat([heads[0] + i * ep for i in range(3)]), 3 * ep)
    lay = {n: (stream,) for n in WEIGHT_NAMES}
    lay.update(qkv_w=(stream, qkv), qkv_b=(qkv,), proj_w=(heads, stream), ffn1_w=(stream, hid),
               ffn1_b=(hid,), ffn2_w=(hid, stream))
    return lay


def _index(dims) -> tuple:
    """The index of a weight's true elements in its padded copy (L first)."""
    if len(dims) == 1:
        return slice(None), dims[0][0]
    return slice(None), dims[0][0][:, None], dims[1][0][None, :]


def pad_weights(weights, e: int, num_heads: int) -> tuple:
    """The 12 stacked (L, ...) operands of width E zero-padded to the
    kernels' widths (``padded_dims``, ``_layouts``); the same tensors when
    nothing is padded."""
    if padded_dims(e, num_heads)[0] == e:
        return tuple(weights)
    lay = _layouts(e, num_heads, weights[0].device)
    out = []
    for n, t in zip(WEIGHT_NAMES, weights):
        p = torch.zeros((t.shape[0], *(size for _, size in lay[n])), dtype=t.dtype,
                        device=t.device)
        p[_index(lay[n])] = t
        out.append(p)
    return tuple(out)


def unpad_grads(grads, e: int, num_heads: int) -> tuple:
    """The gradients of ``pad_weights``'s operands cut back to the true
    shapes: each true element's padded entry."""
    if padded_dims(e, num_heads)[0] == e:
        return tuple(grads)
    lay = _layouts(e, num_heads, grads[0].device)
    return tuple(t[_index(lay[n])] for n, t in zip(WEIGHT_NAMES, grads))


def pad_stream(t, ep: int):
    """(B, S, E) -> (B, S, Ep), zero columns after the E real ones."""
    e = t.shape[-1]
    return t if e == ep else torch.nn.functional.pad(t, (0, ep - e)).contiguous()


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


def _carve(pieces) -> int:
    """Bytes a csrc/sasrec_encoder.cuh ``Carve`` takes for ``pieces`` (bytes
    each, in order): every piece starts 256-byte aligned."""
    used = 0
    for n in pieces:
        used = (used + n + 255) // 256 * 256
    return used


def _split_count(n: int, blocks: int) -> int:
    """The chunks of ``split_for(N, blocks)`` (csrc/sasrec_encoder.cuh)."""
    want = max(1, min(-(-_SPLIT_BLOCKS // blocks), -(-n // 64)))
    chunk = -(-(-(-n // want)) // 64) * 64
    return -(-n // chunk)


def _partial_floats(n: int, ep: int) -> int:
    """Floats of one layer's weight-gradient partials, ``grad_layout(N, Ep,
    L, li).part_total``: each matrix (M, N) split over the tiles it
    launches, the 13 Ep of vectors over the column sums' split."""
    tiles = lambda m: -(-m // _TILE)  # noqa: E731
    mats = ((ep, 3 * ep), (ep, ep), (ep, 4 * ep), (4 * ep, ep))  # qkv_w, proj_w, ffn1_w, ffn2_w
    total = sum(_split_count(n, tiles(m) * tiles(c)) * m * c for m, c in mats)
    return total + _split_count(n, tiles(ep)) * 13 * ep


def fwd_workspace(b: int, s: int, e: int, num_heads: int, bf16: bool) -> int:
    """Bytes of workspace ``encode_fwd``'s kernels take for B rows, the C
    ``sasrec_encode_fwd_workspace`` in Python: fp32 h and qkv, cd hn, ao
    and f1, token-major at the padded width."""
    n, ep = b * s, padded_dims(e, num_heads)[0]
    c = 2 if bf16 else 4
    return _carve((4 * n * ep, c * n * ep, 12 * n * ep, c * n * ep, 4 * c * n * ep))


def bwd_workspace(b: int, s: int, e: int, num_heads: int, layers: int, bf16: bool) -> int:
    """Bytes of workspace ``encode_bwd``'s kernels take for B rows, the C
    ``sasrec_encode_bwd_workspace`` in Python (inside the envelope): each
    layer's residues, the attention's as its route keeps them (the staged
    softmax, or the streamed fp32 output and (m, l) a query), the gradient
    stream's buffers and one layer's weight-gradient partials."""
    n, (ep, dp) = b * s, padded_dims(e, num_heads)
    ne, c = n * ep, 2 if bf16 else 4
    if attention_route(s, dp) == "staged":
        attn = (4 * b * num_heads * s * s,)
    else:
        attn = (4 * ne, 8 * b * num_heads * s)
    layer = (c * ne, 4 * ne, 4 * n, 12 * ne, *attn, c * ne, 4 * ne, 4 * n, c * ne, 4 * c * ne)
    tail = (4 * ne, 4 * ne, c * ne, 16 * ne, 4 * c * ne, 4 * ne, 4 * _partial_floats(n, ep))
    return _carve(layer * layers + tail)


def plan_chunks(b: int, s: int, e: int, num_heads: int, layers: int, dtype: torch.dtype,
                direction: str) -> tuple:
    """The chunks of rows, ((r0, r1), ...) in row order, that a call of B
    histories runs as, each the kernels' whole launch sequence on its rows
    at its own token base, as the TPU kernel's grid walks the batch in
    blocks of rows: as many rows a chunk as keep its B*S within MAX_TOKENS
    and its workspace (``fwd_workspace`` or ``bwd_workspace``,
    ``direction`` "fwd" or "bwd") within WORKSPACE_BUDGET, at least one. A
    pure function of the shapes: no free-memory figure, no device."""
    bf16 = dtype == torch.bfloat16
    if direction == "fwd":
        size = lambda r: fwd_workspace(r, s, e, num_heads, bf16)  # noqa: E731
    elif direction == "bwd":
        size = lambda r: bwd_workspace(r, s, e, num_heads, layers, bf16)  # noqa: E731
    else:
        raise ValueError(f"direction must be 'fwd' or 'bwd', got {direction!r}")
    lo, hi = 1, max(1, min(b, MAX_TOKENS // max(s, 1)))
    if size(hi) <= WORKSPACE_BUDGET:
        lo = hi
    while lo < hi:  # the most rows whose workspace fits (it grows with the rows)
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if size(mid) <= WORKSPACE_BUDGET else (lo, mid - 1)
    return tuple((r0, min(r0 + lo, b)) for r0 in range(0, b, lo))


def call_launches(b: int, s: int, e: int, num_heads: int, layers: int, dtype: torch.dtype,
                  direction: str) -> int:
    """Kernel launches of one ``encode_fwd`` or ``encode_bwd`` call of B
    rows: the launch sequence once a chunk (``plan_chunks``); summing the
    chunks' weight gradients takes no launch of its own."""
    per = fwd_launches(layers) if direction == "fwd" else bwd_launches(layers)
    return per * len(plan_chunks(b, s, e, num_heads, layers, dtype, direction))


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


def _layer_fwd(h, amask, w, li, cd, num_heads, seed, rate, acc=torch.float64, token0=0, e=None):
    """One pre-LN block on the fp32 stream h (B*S, W), composed of the
    plain blocks at the kernels' rounding points (products accumulated in
    ``acc``) -> (new h, the residues the backward needs, the products'
    operands kept in fp32). The attention is the staged or the streamed
    pair's plain version, as the kernels choose (``attention_route``). With
    ``e``, h and w are zero-padded to the kernels' widths (``padded_dims``)
    around a true width e."""
    (qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
     ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b) = (t[li] for t in w)
    e = e or h.shape[1]
    s = amask.shape[1]
    att = dict(scale=1.0 / (e // num_heads) ** 0.5)
    drop = dict(seed=seed, rate=rate, layer=li, acc=acc, token0=token0)
    hn1, xhat1, r1 = layer_norm_plain(h, ln1_s, ln1_b, torch.float32, residues=True, e=e)
    qkv = product_plain(hn1.to(cd), qkv_w.to(cd), "nn", "bias", bias=qkv_b, acc=acc)
    if attention_route(s, padded_dims(e, num_heads)[1]) == "staged":
        ao, p = attention_fwd_plain(qkv, amask, num_heads, torch.float32, **att)
        kept = dict(p=p)
    else:
        ao, _, stats = attention_fwd_streamed_plain(qkv, amask, num_heads, torch.float32, **att)
        kept = dict(stats=stats)
    h1 = product_plain(ao.to(cd), proj_w.to(cd), "nn", "residual", bias=proj_b, aux=h, branch=0,
                       **drop)
    hn2, xhat2, r2 = layer_norm_plain(h1, ln2_s, ln2_b, torch.float32, residues=True, e=e)
    f1 = product_plain(hn2.to(cd), ffn1_w.to(cd), "nn", "relu", bias=ffn1_b,
                       out_dtype=torch.float32, acc=acc)
    h2 = product_plain(f1.to(cd), ffn2_w.to(cd), "nn", "residual", bias=ffn2_b, aux=h1, branch=1,
                       **drop)
    return h2, dict(hn1=hn1, xhat1=xhat1, r1=r1, qkv=qkv, ao=ao, hn2=hn2, xhat2=xhat2, r2=r2,
                    f1=f1, **kept)


def _padded(x, weights, num_heads, padded):
    """(x, weights, e) as the plain versions run them: unchanged with e None,
    or with ``padded`` zero-padded to the kernels' widths around the true e."""
    e = x.shape[-1]
    ep = padded_dims(e, num_heads)[0]
    if not padded or ep == e:
        return x, tuple(weights), None
    return pad_stream(x, ep), pad_weights(weights, e, num_heads), e


def encode_fwd_plain(
    x, amask, qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
    ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b, *, num_heads, seed=None, rate=0.0, token0=0,
    padded=False,
):
    """Plain PyTorch version at the kernel's rounding points, composed of
    the plain blocks: x (B, S, E) in cd, amask (B, S) fp32 additive ->
    (B, S, E) in cd. With ``rate`` > 0 the dropout masks of ``dropout_mask``
    under ``seed`` (tokens counted from ``token0``) multiply a1 and f2.
    ``padded``: run at the kernels' padded widths, as the kernels do, and
    cut the output back (the same function)."""
    w = (qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b, ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b)
    e_out = x.shape[-1]
    x, w, e = _padded(x, w, num_heads, padded)
    b, s, width = x.shape
    h = x.float().reshape(b * s, width)
    for li in range(qkv_w.shape[0]):
        h, _ = _layer_fwd(h, amask, w, li, x.dtype, num_heads, seed, rate, token0=token0, e=e)
    return h.reshape(b, s, width)[..., :e_out].to(x.dtype)


def encode_bwd_plain(g, x, amask, *weights, num_heads, seed=None, rate=0.0,
                     fp32_operands=False, acc=torch.float64, token0=0, padded=False):
    """Plain PyTorch version of the backward: the hand-derived VJP of the TPU
    kernel's ``_bwd_kernel`` (:238-351, with ``_attn_bwd`` :108-136 and
    ``_ln_bwd`` :70-76) at its rounding points, not autograd, composed of
    the plain blocks. g and x (B, S, E) in cd, amask (B, S) fp32, the 12
    stacked weights -> (dx in cd, the 12 weight gradients fp32, summed over
    the batch). Where the keys stream (``attention_route``) the attention's
    backward rebuilds P from the forward's stats, as the kernel does.

    ``fp32_operands=True`` leaves every operand of the backward's products in
    fp32 instead of rounding it to cd: a wrong backward that the bf16 norm bar
    of the checks must reject. In fp32 the two agree. ``acc`` is the
    products' accumulation dtype (``product_plain``). ``padded``: run at the
    kernels' padded widths and cut the gradients back, as the kernels do."""
    cd = x.dtype
    e_out = x.shape[-1]
    x, weights, e = _padded(x, weights, num_heads, padded)
    if e:
        g = pad_stream(g, x.shape[-1])
    b, s, width = x.shape
    att = dict(scale=1.0 / (e_out // num_heads) ** 0.5)

    def rc(t):  # an operand of a backward product
        return t.float() if fp32_operands else t.to(cd)

    h = x.float().reshape(b * s, width)
    saved = []
    for li in range(weights[0].shape[0]):
        h, res = _layer_fwd(h, amask, weights, li, cd, num_heads, seed, rate, acc, token0, e)
        saved.append(res)

    grads = [torch.zeros(t.shape, dtype=torch.float32, device=x.device) for t in weights]
    (dqkv_w, dqkv_b, dproj_w, dproj_b, dln1_s, dln1_b,
     dffn1_w, dffn1_b, dffn2_w, dffn2_b, dln2_s, dln2_b) = grads
    dh = g.float().reshape(b * s, width)
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
        dh = layer_norm_bwd_plain(dn2, res["xhat2"], res["r2"], ln2_s, dh, e)
        # attention branch
        da1 = dropout(dh, seed, li, 0, rate, token0)
        dproj_w[li] = product_plain(rc(res["ao"]), rc(da1), "tn", acc=acc)
        dproj_b[li] = column_sums_plain(da1)[0]
        dao = product_plain(rc(da1), rc(proj_w), "nt", acc=acc)
        if "p" in res:
            dqkv, _ = attention_bwd_plain(res["qkv"], res["p"], dao, cd, **att)
        else:
            dqkv, _ = attention_bwd_streamed_plain(res["qkv"], amask, res["ao"], res["stats"], dao,
                                                   cd, **att)
        dqkv_w[li] = product_plain(rc(res["hn1"]), rc(dqkv), "tn", acc=acc)
        dqkv_b[li] = column_sums_plain(dqkv)[0]
        dn1 = product_plain(rc(dqkv), rc(qkv_w), "nt", acc=acc)
        ds, db = column_sums_plain(dn1, "ln", x=res["xhat1"])
        dln1_s[li], dln1_b[li] = ds[0], db[0]
        dh = layer_norm_bwd_plain(dn1, res["xhat1"], res["r1"], ln1_s, dh, e)
    dx = dh.reshape(b, s, width)[..., :e_out].to(cd)
    return (dx, *(unpad_grads(grads, e_out, num_heads) if e else grads))


def fits(s: int, e: int, num_heads: int, layers: int) -> bool:
    """Whether the kernels take (S, E, H, L), both ways: a pure function of
    the shapes, the C ``sasrec_encoder_fits`` (``shapes_ok``) in Python.
    S >= 1 with no bound of its own (the streamed attention past what shared
    memory holds), any E >= 1 (padded to the kernels' widths), H >= 1 with
    E % H == 0, any head width E / H (the streamed attention walks wide
    heads' output columns in chunks), L >= 1; any batch (cut into chunks,
    ``plan_chunks``). Still refused, at a call (``check_envelope``): a
    history past MAX_STREAM_S."""
    return s >= 1 and e >= 1 and num_heads >= 1 and e % num_heads == 0 and layers >= 1


def check_envelope(s: int, e: int, num_heads: int, layers: int) -> None:
    """Raise unless the kernels take (S, E, H, L) (``fits``) with S within
    MAX_STREAM_S, the streamed attention's grid rows. Any B: a call runs in
    chunks of rows (``plan_chunks``), each inside the C ``in_envelope``. The
    S bound refuses nothing the JAX kernel runs: its attention holds each
    block's (TB, S, S) scores a head, which no device holds at such S."""
    if not fits(s, e, num_heads, layers) or s > MAX_STREAM_S:
        raise ValueError(
            f"outside the kernels' envelope (S >= 1, E % H == 0, L >= 1, S <= {MAX_STREAM_S}, "
            f"the streamed attention's grid rows): S={s}, E={e}, H={num_heads}, L={layers}"
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


def _aligned(t):
    """t, or a copy of it where a chunk's view does not start 16-byte aligned."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def encode_fwd(x, amask, *weights, num_heads, seed=None, rate=0.0, token0=0):
    """x (B, S, E) bf16/fp32, the pos-embedded history with pad rows zeroed;
    amask (B, S) fp32, -1e9 at pad keys; the 12 operands of
    ``stack_weights``; with ``rate`` > 0 the dropout seed, an int64 tensor
    (1,) on x's device, and ``token0`` the global token of row 0 -> the
    encoded history (B, S, E) in x's dtype (pad rows hold what the layers
    left there). Runs in the chunks of rows of ``plan_chunks``, row r0's
    tokens counted from token0 + r0 S."""
    check_dropout(seed, rate)
    if x.device.type == "cpu":
        kw = dict(num_heads=num_heads, seed=seed, rate=rate)
        b, s, e = x.shape
        chunks = plan_chunks(b, s, e, num_heads, weights[0].shape[0], x.dtype, "fwd")
        if len(chunks) < 2:
            return encode_fwd_plain(x, amask, *weights, **kw, token0=token0)
        return torch.cat([encode_fwd_plain(x[r0:r1], amask[r0:r1], *weights, **kw,
                                           token0=token0 + r0 * s) for r0, r1 in chunks])
    b, s, e, layers = _check_envelope("encode_fwd", x, amask, weights, num_heads, seed, rate)
    out = torch.empty_like(x)
    chunks = plan_chunks(b, s, e, num_heads, layers, x.dtype, "fwd")
    if not chunks:
        return out
    rows = chunks[0][1]
    ep = padded_dims(e, num_heads)[0]
    wp = pad_weights(weights, e, num_heads)
    lib = fwd_lib()
    ws = _workspace(lib.sasrec_encode_fwd_workspace(rows, s, e, num_heads, is_bf16(x)), x.device)
    padded = None if ep == e else torch.empty((rows, s, ep), dtype=x.dtype, device=x.device)
    for r0, r1 in chunks:
        # held until the launch: a freed copy's memory may back the next one
        xc, ac = pad_stream(x[r0:r1], ep), _aligned(amask[r0:r1])
        oc = out[r0:r1] if padded is None else padded[: r1 - r0]
        seed_ptr, *drop = dropout_args(seed, rate, token0 + r0 * s)
        rc = lib.sasrec_encode_fwd(
            xc.data_ptr(), ac.data_ptr(), *(t.data_ptr() for t in wp), seed_ptr, oc.data_ptr(),
            ws.data_ptr(), r1 - r0, s, e, num_heads, layers, 1.0 / (e // num_heads) ** 0.5,
            *drop, is_bf16(x), stream_of(x),
        )
        build.check(rc, "encode_fwd")
        encode_fwd.launches += fwd_launches(layers)
        if padded is not None:
            out[r0:r1] = oc[..., :e]
    return out


encode_fwd.launches = 0


def encode_bwd(g, x, amask, *weights, num_heads, seed=None, rate=0.0, token0=0):
    """g and x (B, S, E) in the compute dtype (g the cotangent of
    ``encode_fwd``'s output, x its input), amask (B, S), the 12 operands of
    ``stack_weights`` and the forward's seed, rate and token0 -> (dx in x's
    dtype, the 12 weight gradients fp32 in the shapes of the weights). Runs
    in the chunks of rows of ``plan_chunks``: dx chunk by chunk, the weight
    gradients the chunks' sums added in chunk order."""
    check_dropout(seed, rate)
    if x.device.type == "cpu":
        kw = dict(num_heads=num_heads, seed=seed, rate=rate)
        b, s, e = x.shape
        chunks = plan_chunks(b, s, e, num_heads, weights[0].shape[0], x.dtype, "bwd")
        if len(chunks) < 2:
            return encode_bwd_plain(g, x, amask, *weights, **kw, token0=token0)
        dxs, total = [], None
        for r0, r1 in chunks:
            dx, *grads = encode_bwd_plain(g[r0:r1], x[r0:r1], amask[r0:r1], *weights, **kw,
                                          token0=token0 + r0 * s)
            dxs.append(dx)
            total = grads if total is None else [a + c for a, c in zip(total, grads)]
        return (torch.cat(dxs), *total)
    b, s, e, layers = _check_envelope("encode_bwd", x, amask, weights, num_heads, seed, rate)
    if tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected {tuple(x.shape)}")
    check_kernel_args({"g": (g, None)}, x.dtype, x.device)
    ep = padded_dims(e, num_heads)[0]
    wp = pad_weights(weights, e, num_heads)
    sizes = [t.numel() for t in wp]  # the gradients, one after another
    out = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    chunks = plan_chunks(b, s, e, num_heads, layers, x.dtype, "bwd")
    if chunks:
        rows = chunks[0][1]
        lib = bwd_lib()
        ws = _workspace(lib.sasrec_encode_bwd_workspace(rows, s, e, num_heads, layers,
                                                        is_bf16(x)), x.device)
        padded = None if ep == e else torch.empty((rows, s, ep), dtype=x.dtype, device=x.device)
        for i, (r0, r1) in enumerate(chunks):
            gc, xc = pad_stream(g[r0:r1], ep), pad_stream(x[r0:r1], ep)
            ac = _aligned(amask[r0:r1])
            dc = dx[r0:r1] if padded is None else padded[: r1 - r0]
            seed_ptr, *drop = dropout_args(seed, rate, token0 + r0 * s)
            rc = lib.sasrec_encode_bwd(
                gc.data_ptr(), xc.data_ptr(), ac.data_ptr(), *(t.data_ptr() for t in wp),
                seed_ptr, dc.data_ptr(), out.data_ptr(), ws.data_ptr(), r1 - r0, s, e, num_heads,
                layers, 1.0 / (e // num_heads) ** 0.5, *drop, is_bf16(x), int(i > 0),
                stream_of(x),
            )
            build.check(rc, "encode_bwd")
            encode_bwd.launches += bwd_launches(layers)
            if padded is not None:
                dx[r0:r1] = dc[..., :e]
    else:
        out.zero_()
    grads = unpad_grads([t.view(w.shape) for t, w in zip(torch.split(out, sizes), wp)], e,
                        num_heads)
    return (dx, *grads)


encode_bwd.launches = 0


class FusedEncoder(torch.autograd.Function):
    """The encoder on the kernels both ways, as ``jax.custom_vjp`` wraps the
    TPU kernels: it takes the fp32 master weights and returns fp32 weight
    gradients; the four matrices are cast to the compute dtype inside, and
    x (not the output) is kept for the backward, which recomputes the rest
    and redraws the dropout masks from the same seed and token0. Each way is
    one span over all its chunks while a profiler runs: ``encoder.fwd``,
    ``encoder.bwd``."""

    @staticmethod
    def forward(ctx, x, amask, seed, rate, num_heads, token0, *weights):
        with span("encoder.fwd"):
            ctx.save_for_backward(x, amask, seed, *weights)
            ctx.rate, ctx.num_heads, ctx.token0 = rate, num_heads, token0
            return encode_fwd(x, amask, *cast_matrices(weights, x.dtype), num_heads=num_heads,
                              seed=seed, rate=rate, token0=token0)

    @staticmethod
    def backward(ctx, g):
        with span("encoder.bwd"):
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
