"""The SASRec encoder's building blocks (csrc/sasrec_encoder.cuh), each a
hand-written kernel with its plain PyTorch version, token-major: every
tensor is (N, width) row-major over the N = B*S tokens of a batch.

- ``product``: the tile product (csrc/tile_mma.cuh; bf16 operands on the
  tensor cores through ``mma.sync``, fp32 on the CUDA cores, never TF32)
  with the encoder's epilogues, in three layouts: "nn" A W (the forward's
  four products), "nt" A W^T (the backward's transposed products, W read as
  stored), "tn" A^T G over chunks of tokens (a weight gradient's partials);
- ``layer_norm`` and ``layer_norm_bwd``: fp32, eps 1e-6, a warp a row, the
  statistics over a row's first E columns (a padded row's others written 0);
- ``attention_fwd`` and ``attention_bwd``, staged: fp32 on the CUDA cores, a
  block per (history, head), S <= 128 (up to four keys a lane), the head's
  rows staged whole in shared memory (``attn_fwd_smem`` / ``attn_bwd_smem``
  bytes, within ``MAX_SMEM``);
- ``attention_fwd_streamed`` and ``attention_bwd_streamed``: fp32 on the
  tensor cores in 3xTF32 (each operand split into two TF32 halves, three
  ``mma.sync`` a product: fp32's accuracy), any S and any head width, a block
  per (history, head, up to ``ATTN_BLOCK_ROWS`` rows), the other side walked in
  tiles of ``ATTN_TILE`` rows with the online softmax; the forward keeps
  each query's running max and sum (m, l) and its fp32 output, from which
  the backward rebuilds P a tile at a time (FlashAttention-2's backward,
  without atomics). Heads up to ``ATTN_WHOLE`` deep are staged in shared
  memory (``attn_stream_smem``), deeper ones read from device memory. The
  encoder takes the staged pair where ``attention_route`` says so and the
  streamed pair everywhere else;
- ``column_sums``: bias gradients, LayerNorm's dscale and dbias and the
  dropout gate on dh, over the same token chunks; ``reduce_partials``: the
  fixed-order sum of a chunked partial.

``sasrec_encoder.encode_fwd`` / ``encode_bwd`` enqueue these kernels in one
C call each; the wrappers here launch one block at a time, for the checks
on the card. On a CPU tensor each wrapper runs its plain version; on a CUDA
tensor it launches its kernel or raises. The plain versions are what
``encode_fwd_plain`` and ``encode_bwd_plain`` are composed of.

Dropout (``dropout_mask``) comes from a counter-based generator,
Philox4x32-10, keyed by (seed, global token token0 + b*S + s, column, layer,
branch); ``dropout_keep`` in csrc/common.cuh draws the same bits, so kernels
and plain versions apply the same masks however they tile the tokens.
``token0`` (default 0) is the global token of the batch's first row: a
data-parallel rank passes its first global row times S, and so draws the
masks of its rows of the global batch.
"""

from __future__ import annotations

import ctypes

import torch

from ctr_recommendation_tpu_torch.ops.cuda import build
from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
    check_kernel_args,
    cuda_only,
    is_bf16,
    stream_of,
)

LN_EPS = 1e-6
MAX_S = 128  # kMaxS: the staged attention, KC = ceil(S / 32) <= 4 keys a lane
MAX_SMEM = 232_448  # shared memory an H100 block may opt into (kMaxSmem)
ATTN_TILE = 32  # kTile: the other side's rows a streamed attention step takes
ATTN_BLOCK_ROWS = 64  # kBlockRows: a streamed attention block's own rows, 16 a warp
ATTN_WHOLE = 128  # kWhole: head depths the streamed attention stages whole


def attn_ld(d: int) -> int:
    """Row stride (floats) of a head staged in shared memory: d rounded to
    16-byte rows with ld / 4 odd (csrc/sasrec_encoder.cuh ``attn_ld``)."""
    return ((d // 4) | 1) * 4


def attn_fwd_smem(s: int, d: int) -> int:
    """Shared-memory bytes of the attention forward: q, k, v and the mask."""
    return (3 * s * attn_ld(d) + s) * 4


def attn_bwd_smem(s: int, d: int) -> int:
    """Shared-memory bytes of the attention backward: q, k, v, g, P and dlog."""
    return (4 * s * attn_ld(d) + 2 * s * (s + 1)) * 4


def attn_depth(d: int) -> int:
    """The depth a streamed attention kernel runs a head of width d at
    (csrc/sasrec_encoder.cuh ``attn_staged_depth``): staged in shared
    memory, d padded to 32, 64 or ATTN_WHOLE; 0 past ATTN_WHOLE, where the
    heads are read from device memory."""
    dk = -(-d // 8) * 8
    return next((w for w in (32, 64, ATTN_WHOLE) if dk <= w), 0)


def attn_own_rows(s: int) -> int:
    """A streamed attention block's own rows: S rounded up to 16 (a warp's
    m16n8k8 row tile), at most ATTN_BLOCK_ROWS (``attn_own_rows``)."""
    return min(ATTN_BLOCK_ROWS, -(-s // 16) * 16)


def attn_stream_smem(s: int, d: int) -> tuple[int, int]:
    """Shared-memory bytes of the streamed attention (forward, backward) at
    (S, D) (csrc/sasrec_encoder.cuh ``attn_stream_*_smem``): for a staged
    head, rows of attn_depth(D) + 4 floats, the block's own rows (one
    operand forward, two backward) and each buffer's two operands (two
    buffers where S takes more than one tile of ATTN_TILE); then the masks,
    each query tile's (m, l), 1 / l and Di, and the own rows' mask or Di."""
    r, nb, dk = attn_own_rows(s), 2 if s > ATTN_TILE else 1, attn_depth(d)
    ld = dk + 4 if dk else 0
    return ((r + 2 * nb * ATTN_TILE) * ld + nb * ATTN_TILE) * 4, (
        (2 * r + 2 * nb * ATTN_TILE) * ld + 4 * nb * ATTN_TILE + r) * 4


STAGED_S = 20  # kStagedS: the longest history the staged pair takes at heads up to 64 deep


def staged_fits(s: int, d: int) -> bool:
    """Whether the staged attention takes (S, D): its heads whole in shared
    memory both ways (csrc/sasrec_encoder.cuh ``attn_staged_fits``)."""
    return s <= MAX_S and attn_fwd_smem(s, d) <= MAX_SMEM and attn_bwd_smem(s, d) <= MAX_SMEM


def attention_route(s: int, d: int) -> str:
    """The encoder's attention at (S, D) (csrc/sasrec_encoder.cuh
    ``attn_staged``; D the head width the kernels run, padded to 4):
    "staged" where the staged pair fits and ran a training step's attention
    faster on an H100 (heads deeper than 64, or histories up to STAGED_S),
    else "streamed"."""
    return "staged" if staged_fits(s, d) and (d > 64 or s <= STAGED_S) else "streamed"

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


def dropout_mask(seed, n_tokens: int, e: int, layer: int, branch: int, rate: float,
                 token0: int = 0):
    """Keep mask (n_tokens, e) bool of dropout site (layer, branch): element
    (t, c) is Philox4x32-10 word c % 4 of counter ((token0 + t) mod 2^32,
    c // 4, 2 layer + branch, 0) under key (seed's low, high 32 bits), so
    a column keeps its bits whatever the width around it; u =
    (word >> 8) 2^-24, the TPU kernel's top-24-bit rule, and the element is
    kept iff u >= rate (compared in fp32). ``seed`` is an int64 tensor (1,)
    on the device of the result, or an int; nothing is read back to the
    host."""
    seed = torch.as_tensor(seed, dtype=torch.int64).reshape(-1)[:1]
    dev = seed.device
    t = ((token0 + torch.arange(n_tokens, dtype=torch.int64, device=dev)) & _U32)[:, None]
    q = torch.arange(-(-e // 4), dtype=torch.int64, device=dev)[None, :]
    words = philox4x32(
        (t, q, torch.full((), 2 * layer + branch, dtype=torch.int64, device=dev),
         torch.zeros((), dtype=torch.int64, device=dev)),
        (seed & _U32, (seed >> 32) & _U32),
    )
    w = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(n_tokens, -1)[:, :e]
    u = (w >> 8).to(torch.float32) * 2.0**-24
    return u >= torch.tensor(rate, dtype=torch.float32, device=dev)


def dropout(a, seed, layer, branch, rate, token0=0):
    """a (N, E) fp32 with the kernels' dropout applied: kept elements scaled
    by fp32(1 / (1 - rate)), the rest 0; a unchanged at rate 0."""
    if rate <= 0.0:
        return a
    keep = dropout_mask(seed, a.shape[0], a.shape[1], layer, branch, rate, token0)
    return torch.where(keep, a * (1.0 / (1.0 - rate)), torch.zeros((), device=a.device))


def heads(t, b, s, h):
    """(B*S, H*D) -> (B, H, S, D)."""
    return t.reshape(b, s, h, -1).transpose(1, 2)


def merge(t):
    """(B, H, S, D) -> (B*S, H*D)."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b * s, h * d)


# ---------------------------------------------------------------- plain versions

_LAYOUTS = ("nn", "nt", "tn")
_EPILOGUES = ("store", "bias", "relu", "residual", "gate", "partial")


def product_plain(a, b, layout="nn", epilogue="store", *, bias=None, aux=None, seed=None,
                  rate=0.0, layer=0, branch=0, out_dtype=None, chunk=None, acc=torch.float64,
                  token0=0):
    """C = A B ("nn": a (M, K), b (K, N)), A B^T ("nt": b (N, K)) or A^T B
    ("tn": a (K, M), b (K, N)) of the operands as given, accumulated in
    ``acc`` and rounded to fp32: fp64 by default, as the kernels' fp32 path
    does, so that a ReLU gate z1 > 0 read from the same operands falls on
    the same side in both; fp32 to sum as cuBLAS does. Then the epilogue:

    - "store": C; "bias": C + bias (fp32);
    - "relu": relu(C + bias) in ``out_dtype`` (the FFN's hidden f1);
    - "residual": aux + dropout(C + bias) at site (layer, branch), aux the
      fp32 stream; fp32, or rounded to ``out_dtype`` when given;
    - "gate": C where aux > 0, else 0 (the ReLU gate, aux = f1): (fp32, its
      copy in a's dtype);
    - "partial" ("tn"): (Z, M, N), the product over each chunk of ``chunk``
      rows of a and b."""
    if layout not in _LAYOUTS or epilogue not in _EPILOGUES:
        raise ValueError(f"no product {layout!r} with epilogue {epilogue!r}")
    cd = a.dtype
    a, b = a.to(acc), b.to(acc)
    if epilogue == "partial":
        return torch.stack([a[i:i + chunk].T @ b[i:i + chunk]
                            for i in range(0, a.shape[0], chunk)]).float()
    c = (a @ b if layout == "nn" else a @ b.T if layout == "nt" else a.T @ b).float()
    if epilogue == "store":
        return c
    if epilogue == "bias":
        return c + bias
    if epilogue == "relu":
        return torch.relu(c + bias).to(out_dtype)
    if epilogue == "residual":
        y = aux + dropout(c + bias, seed, layer, branch, rate, token0)
        return y if out_dtype is None else y.to(out_dtype)
    y = c * (aux.float() > 0.0)
    return y, y.to(cd)


def _pad_cols(t, width):
    return t if t.shape[1] == width else torch.nn.functional.pad(t, (0, width - t.shape[1]))


def layer_norm_plain(h, scale, bias, cd, residues=False, e=None):
    """fp32 LayerNorm of h (N, E), the TPU kernel's ``_ln_fwd`` -> hn =
    (xhat * scale + bias) rounded to cd; with ``residues`` (hn, xhat,
    rstd (N,)). With ``e``, h is a zero-padded (N, W) whose first e columns
    are the row: the statistics over those, every output 0 after them."""
    w = h.shape[1]
    h = h[:, :e] if e else h
    m = h.mean(-1, keepdim=True)
    r = torch.rsqrt((h - m).square().mean(-1, keepdim=True) + LN_EPS)
    xhat = (h - m) * r
    hn = _pad_cols((xhat * scale[:h.shape[1]] + bias[:h.shape[1]]).to(cd), w)
    return (hn, _pad_cols(xhat, w), r[:, 0]) if residues else hn


def layer_norm_bwd_plain(dn, xhat, rstd, scale, dh, e=None):
    """dh + the backward of y = xhat * scale + bias at cotangent dn (the TPU
    kernel's ``_ln_bwd``), fp32. With ``e``, over the first e of the padded
    rows' columns, 0 after them."""
    w = dn.shape[1]
    if e:
        dn, xhat, scale, dh = dn[:, :e], xhat[:, :e], scale[:e], dh[:, :e]
    d = dn * scale
    dx = rstd[:, None] * (d - d.mean(-1, keepdim=True)
                          - xhat * (d * xhat).mean(-1, keepdim=True))
    return _pad_cols(dh + dx, w)


def attention_fwd_plain(qkv, amask, num_heads, cd, *, scale=None):
    """The staged attention's plain version. qkv (B*S, 3E) fp32, amask (B, S)
    additive fp32 -> (ao (B*S, E) in cd, p (B, H, S, S) fp32): per head
    softmax(q k^T / sqrt(D) + mask) v, fp32, the TPU kernel's ``_attn_fwd``.
    ``scale``: 1/sqrt(D) by default; the true D's where the heads run
    zero-padded (the encoder's padded widths)."""
    b, s = amask.shape
    e = qkv.shape[1] // 3
    scale = scale or 1.0 / (e // num_heads) ** 0.5
    q, k, v = (heads(t, b, s, num_heads) for t in qkv.split(e, -1))
    p = torch.softmax(q @ k.transpose(-1, -2) * scale + amask.float()[:, None, None, :], dim=-1)
    return merge(p @ v).to(cd), p


def attention_bwd_plain(qkv, p, dao, cd, *, scale=None):
    """The staged attention backward's plain version, the TPU kernel's
    ``_attn_bwd``, fp32: qkv (B*S, 3E), the softmax p (B, H, S, S), dao
    (B*S, E) -> (dqkv (B*S, 3E), dqkv rounded to cd)."""
    b, h, s, _ = p.shape
    e = dao.shape[1]
    inv = scale or 1.0 / (e // h) ** 0.5
    g = heads(dao, b, s, h)
    q, k, v = (heads(t, b, s, h) for t in qkv.split(e, -1))
    dp = g @ v.transpose(-1, -2)
    dlog = p * (dp - (dp * p).sum(-1, keepdim=True)) * inv
    dqkv = torch.cat([merge(dlog @ k), merge(dlog.transpose(-1, -2) @ q),
                      merge(p.transpose(-1, -2) @ g)], dim=-1)
    return dqkv, dqkv.to(cd)


def _dots(a, b):
    """a (..., M, D) . b (..., N, D) -> (..., M, N): fp32 operands, each sum
    in fp64 rounded once to fp32 (the kernels sum 3xTF32 products in fp32 on
    the tensor cores: within the fp32 bars, and a zero-padded D changes
    nothing here)."""
    return (a.double() @ b.double().transpose(-1, -2)).float()


def _weighted(a, rows):
    """a (..., M, N) times rows (..., N, D) -> (..., M, D), summed as ``_dots``."""
    return (a.double() @ rows.double()).float()


def attention_fwd_streamed_plain(qkv, amask, num_heads, cd, *, scale=None):
    """The streamed attention's plain version, in the kernel's order: the
    keys in tiles of ATTN_TILE, each query's running max m and sum l of
    exp(logit - m), its output rescaled by exp(m - m') where a tile raises
    the max, divided by l at the end. qkv (B*S, 3E) fp32, amask (B, S) ->
    (ao (B*S, E) in cd, o (B*S, E) fp32, stats (B, H, S, 2) fp32: m and l).
    ``scale`` as for ``attention_fwd_plain``."""
    b, s = amask.shape
    e = qkv.shape[1] // 3
    scale = scale or 1.0 / (e // num_heads) ** 0.5
    q, k, v = (heads(t, b, s, num_heads) for t in qkv.split(e, -1))
    mask = amask.float()[:, None, None, :]
    m = torch.full(q.shape[:3], -3.0e38, device=qkv.device)
    l = torch.zeros(q.shape[:3], device=qkv.device)
    o = torch.zeros(q.shape, device=qkv.device)
    for j0 in range(0, s, ATTN_TILE):
        j1 = min(s, j0 + ATTN_TILE)
        logit = _dots(q, k[:, :, j0:j1]) * scale + mask[..., j0:j1]
        mn = torch.maximum(m, logit.amax(-1))
        alpha = torch.exp(m - mn)
        ex = torch.exp(logit - mn[..., None])
        l = l * alpha + ex.sum(-1)
        o = o * alpha[..., None] + _weighted(ex, v[:, :, j0:j1])
        m = mn
    out = merge(o / l[..., None])
    return out.to(cd), out, torch.stack([m, l], dim=-1)


def attention_bwd_streamed_plain(qkv, amask, o, stats, dao, cd, *, scale=None):
    """The streamed attention backward's plain version, in the kernel's
    order: P = exp(logit - m) / l rebuilt a key tile at a time from the
    forward's stats, Di = dao . o per query and head, ds = P (dao . v - Di)
    scale; dq summed over the key tiles in order, dk and dv over all
    queries. qkv (B*S, 3E), amask (B, S), o (B*S, E) fp32 (the forward's
    output), stats (B, H, S, 2), dao (B*S, E) -> (dqkv (B*S, 3E) fp32, dqkv
    rounded to cd)."""
    b, h, s, _ = stats.shape
    e = dao.shape[1]
    scale = scale or 1.0 / (e // h) ** 0.5
    g = heads(dao, b, s, h)
    q, k, v = (heads(t, b, s, h) for t in qkv.split(e, -1))
    di = (g.double() * heads(o, b, s, h).double()).sum(-1).float()
    m, l = stats[..., :1], stats[..., 1:]
    mask = amask.float()[:, None, None, :]
    dq = torch.zeros(q.shape, device=qkv.device)
    dk, dv = [], []
    for j0 in range(0, s, ATTN_TILE):
        j1 = min(s, j0 + ATTN_TILE)
        logit = _dots(q, k[:, :, j0:j1]) * scale + mask[..., j0:j1]
        p = torch.exp(logit - m) / l
        ds = p * (_dots(g, v[:, :, j0:j1]) - di[..., None]) * scale
        dq = dq + _weighted(ds, k[:, :, j0:j1])
        dk.append(_weighted(ds.transpose(-1, -2), q))
        dv.append(_weighted(p.transpose(-1, -2), g))
    dqkv = torch.cat([merge(dq), merge(torch.cat(dk, 2)), merge(torch.cat(dv, 2))], dim=-1)
    return dqkv, dqkv.to(cd)


def column_sums_plain(g, mode="sum", *, x=None, seed=None, rate=0.0, layer=0, branch=0,
                      cd=None, chunk=None, token0=0):
    """Column sums of g (N, C) fp32 over chunks of ``chunk`` rows (one chunk
    when None) -> (Z, C) partials: "sum" of g; "ln" (sum g x, sum g); "gate"
    v = dropout(g) at site (layer, branch): (sum v, v in cd). Each sum in
    fp64 rounded once to fp32 (the kernel sums in fp32 in a fixed order:
    within the bars; zero columns beside a column change nothing here)."""
    chunk = chunk or g.shape[0]

    def sums(t):
        return torch.stack([t[i:i + chunk].double().sum(0)
                            for i in range(0, t.shape[0], chunk)]).float()

    if mode == "sum":
        return sums(g)
    if mode == "ln":
        return sums(g * x), sums(g)
    if mode == "gate":
        v = dropout(g, seed, layer, branch, rate, token0)
        return sums(v), v.to(cd)
    raise ValueError(f"no column sums {mode!r}")


def reduce_partials_plain(part):
    """(Z, n) -> (n,), the sum over z."""
    return part.sum(0)


# ---------------------------------------------------------------- the kernels

_FWD = None
_BWD = None
_VP, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint


def fwd_lib():
    """csrc/sasrec_encoder.cu, built and bound at first use."""
    global _FWD
    if _FWD is None:
        lib = build.load("sasrec_encoder")
        lib.sasrec_encode_fwd_workspace.argtypes = [_I] * 5
        lib.sasrec_encode_fwd_workspace.restype = ctypes.c_size_t
        lib.sasrec_encode_fwd.argtypes = [_VP] * 17 + [_I] * 5 + [_F] * 3 + [_U, _I, _VP]
        lib.sasrec_product_fwd.argtypes = (
            [_I] + [_VP] * 2 + [_I] * 3 + [_VP] * 4 + [_F] * 2 + [_U] + [_I] * 3 + [_VP])
        lib.sasrec_layer_norm.argtypes = [_VP, _I, _I, _I] + [_VP] * 5 + [_I, _VP]
        lib.sasrec_attention_fwd.argtypes = [_VP] * 4 + [_I] * 5 + [_F, _I, _VP]
        lib.sasrec_attention_fwd_streamed.argtypes = [_VP] * 5 + [_I] * 5 + [_F, _I, _VP]
        lib.sasrec_encoder_fits.argtypes = [_I] * 4
        lib.sasrec_encoder_widths.argtypes = [_I] * 2
        lib.sasrec_attention_staged.argtypes = [_I] * 3
        _FWD = lib
    return _FWD


def bwd_lib():
    """csrc/sasrec_encoder_bwd.cu, built and bound at first use."""
    global _BWD
    if _BWD is None:
        lib = build.load("sasrec_encoder_bwd")
        lib.sasrec_encode_bwd_workspace.argtypes = [_I] * 6
        lib.sasrec_encode_bwd_workspace.restype = ctypes.c_size_t
        lib.sasrec_encode_bwd.argtypes = [_VP] * 19 + [_I] * 5 + [_F] * 3 + [_U, _I, _I, _VP]
        lib.sasrec_product_bwd.argtypes = [_I, _I, _VP, _VP] + [_I] * 5 + [_VP] * 3 + [_I, _VP]
        lib.sasrec_layer_norm_bwd.argtypes = [_VP] * 6 + [_I] * 5 + [_VP]
        lib.sasrec_attention_bwd.argtypes = [_VP] * 5 + [_I] * 5 + [_F, _I, _VP]
        lib.sasrec_attention_bwd_streamed.argtypes = [_VP] * 7 + [_I] * 5 + [_F, _I, _VP]
        lib.sasrec_column_sums.argtypes = (
            [_I] + [_VP] * 4 + [_F] * 2 + [_U] + [_I] * 6 + [_VP] * 2 + [_I, _VP])
        lib.sasrec_reduce_partials.argtypes = [_VP, _I, _I, _VP, _VP]
        _BWD = lib
    return _BWD


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def check_dropout(seed, rate) -> None:
    """The dropout arguments, on any device: 0 <= rate < 1, and a seed when
    rate > 0."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("dropout (rate > 0) needs a seed: an int64 tensor of shape (1,)")


def dropout_args(seed, rate, token0=0):
    """(seed pointer or None, rate, 1 / (1 - rate), token0 mod 2^32) for a C
    entry point."""
    check_dropout(seed, rate)
    return (seed.data_ptr() if rate > 0.0 else None), rate, 1.0 / (1.0 - rate), token0 & _U32


_FWD_EPI = {"bias": 1, "relu": 2, "residual": 3}
_BWD_EPI = {("nt", "store"): 0, ("nt", "gate"): 5, ("tn", "partial"): 6}


def product(a, b, layout="nn", epilogue="store", *, bias=None, aux=None, seed=None, rate=0.0,
            layer=0, branch=0, out_dtype=None, chunk=None, token0=0):
    """``product_plain`` on CPU tensors; on CUDA tensors the tile product
    kernel, one launch, in the combinations the encoder runs: "nn" with
    "bias", "relu" or "residual"; "nt" with "store" or "gate"; "tn" with
    "partial" (chunk % 64 == 0). a and b in one compute dtype (bf16 or
    fp32), contiguous; N and K multiples of 32."""
    kw = dict(bias=bias, aux=aux, seed=seed, rate=rate, layer=layer, branch=branch,
              out_dtype=out_dtype, chunk=chunk, token0=token0)
    if a.device.type == "cpu":
        return product_plain(a, b, layout, epilogue, **kw)
    cuda_only("product", a)
    check_kernel_args({"a": (a, None), "b": (b, None)}, a.dtype, a.device)
    m, k = a.shape if layout != "tn" else a.shape[::-1]
    n = b.shape[0] if layout == "nt" else b.shape[1]
    f32 = torch.float32
    dev = a.device
    drop = dropout_args(seed, rate, token0)
    if layout == "nn" and epilogue in _FWD_EPI:
        out_f, out_c = None, None
        if epilogue == "bias":
            out_f = torch.empty(m, n, dtype=f32, device=dev)
        elif epilogue == "relu":
            out_c = torch.empty(m, n, dtype=out_dtype, device=dev)
        else:
            out_f = aux.clone()
            if out_dtype is not None:
                out_c = torch.empty(m, n, dtype=out_dtype, device=dev)
        epi = _FWD_EPI[epilogue] + (1 if epilogue == "residual" and out_c is not None else 0)
        rc = fwd_lib().sasrec_product_fwd(
            epi, a.data_ptr(), b.data_ptr(), m, n, k, ptr(bias), ptr(out_f), ptr(out_c),
            *drop, layer, branch, is_bf16(a), stream_of(a))
        build.check(rc, f"product {layout} {epilogue}")
        return out_c if out_c is not None else out_f
    code = _BWD_EPI.get((layout, epilogue))
    if code is None:
        raise ValueError(f"no product kernel {layout!r} with epilogue {epilogue!r}")
    splits = -(-k // chunk) if epilogue == "partial" else 1
    out_f = torch.empty((splits, m, n) if epilogue == "partial" else (m, n), dtype=f32, device=dev)
    out_c = torch.empty(m, n, dtype=a.dtype, device=dev) if epilogue == "gate" else None
    rc = bwd_lib().sasrec_product_bwd(
        1 if layout == "nt" else 2, code, a.data_ptr(), b.data_ptr(), m, n, k, splits,
        chunk if epilogue == "partial" else k, ptr(aux), out_f.data_ptr(), ptr(out_c),
        is_bf16(a), stream_of(a))
    build.check(rc, f"product {layout} {epilogue}")
    return (out_f, out_c) if epilogue == "gate" else out_f


def layer_norm(h, scale, bias, cd, residues=False, e=None):
    """``layer_norm_plain`` on CPU tensors, the LayerNorm kernel on CUDA."""
    if h.device.type == "cpu":
        return layer_norm_plain(h, scale, bias, cd, residues, e)
    cuda_only("layer_norm", h)
    n, w = h.shape
    out = torch.empty(n, w, dtype=cd, device=h.device)
    xhat = torch.empty(n, w, device=h.device) if residues else None
    rstd = torch.empty(n, device=h.device) if residues else None
    rc = fwd_lib().sasrec_layer_norm(h.data_ptr(), n, w, e or w, scale.data_ptr(),
                                     bias.data_ptr(), out.data_ptr(), ptr(xhat), ptr(rstd),
                                     int(cd == torch.bfloat16), stream_of(h))
    build.check(rc, "layer_norm")
    return (out, xhat, rstd) if residues else out


def layer_norm_bwd(dn, xhat, rstd, scale, dh, e=None):
    """``layer_norm_bwd_plain`` on CPU tensors, the kernel on CUDA (fp32 out)."""
    if dn.device.type == "cpu":
        return layer_norm_bwd_plain(dn, xhat, rstd, scale, dh, e)
    cuda_only("layer_norm_bwd", dn)
    out = torch.empty_like(dh)
    n, w = dn.shape
    rc = bwd_lib().sasrec_layer_norm_bwd(
        dn.data_ptr(), xhat.data_ptr(), rstd.data_ptr(), scale.data_ptr(), dh.data_ptr(),
        out.data_ptr(), n, w, e or w, 0, 0, stream_of(dn))
    build.check(rc, "layer_norm_bwd")
    return out


def _attention_dims(qkv, num_heads, scale):
    """(E, D, scale) of an attention block's call."""
    e = qkv.shape[1] // 3
    return e, e // num_heads, scale or 1.0 / (e // num_heads) ** 0.5


def attention_fwd(qkv, amask, num_heads, cd, *, scale=None):
    """``attention_fwd_plain`` on CPU tensors, the staged kernel on CUDA."""
    if qkv.device.type == "cpu":
        return attention_fwd_plain(qkv, amask, num_heads, cd, scale=scale)
    cuda_only("attention_fwd", qkv)
    b, s = amask.shape
    e, d, scale = _attention_dims(qkv, num_heads, scale)
    ao = torch.empty(b * s, e, dtype=cd, device=qkv.device)
    p = torch.empty(b, num_heads, s, s, device=qkv.device)
    rc = fwd_lib().sasrec_attention_fwd(
        qkv.data_ptr(), amask.data_ptr(), ao.data_ptr(), p.data_ptr(), b, s, e, num_heads, d,
        scale, int(cd == torch.bfloat16), stream_of(qkv))
    build.check(rc, "attention_fwd")
    return ao, p


def attention_bwd(qkv, p, dao, cd, *, scale=None):
    """``attention_bwd_plain`` on CPU tensors, the staged kernel on CUDA."""
    if qkv.device.type == "cpu":
        return attention_bwd_plain(qkv, p, dao, cd, scale=scale)
    cuda_only("attention_bwd", qkv)
    b, h, s, _ = p.shape
    e, d, scale = _attention_dims(qkv, h, scale)
    dqkv = torch.empty_like(qkv)
    dqkv_c = torch.empty(qkv.shape, dtype=cd, device=qkv.device)
    rc = bwd_lib().sasrec_attention_bwd(
        qkv.data_ptr(), p.data_ptr(), dao.data_ptr(), dqkv.data_ptr(), dqkv_c.data_ptr(), b, s, e,
        h, d, scale, int(cd == torch.bfloat16), stream_of(qkv))
    build.check(rc, "attention_bwd")
    return dqkv, dqkv_c


def attention_fwd_streamed(qkv, amask, num_heads, cd, *, scale=None):
    """``attention_fwd_streamed_plain`` on CPU tensors, the streamed kernel on
    CUDA: (ao in cd, o fp32, stats (B, H, S, 2))."""
    if qkv.device.type == "cpu":
        return attention_fwd_streamed_plain(qkv, amask, num_heads, cd, scale=scale)
    cuda_only("attention_fwd_streamed", qkv)
    b, s = amask.shape
    e, d, scale = _attention_dims(qkv, num_heads, scale)
    ao = torch.empty(b * s, e, dtype=cd, device=qkv.device)
    o = torch.empty(b * s, e, device=qkv.device)
    stats = torch.empty(b, num_heads, s, 2, device=qkv.device)
    rc = fwd_lib().sasrec_attention_fwd_streamed(
        qkv.data_ptr(), amask.data_ptr(), ao.data_ptr(), o.data_ptr(), stats.data_ptr(), b, s, e,
        num_heads, d, scale, int(cd == torch.bfloat16), stream_of(qkv))
    build.check(rc, "attention_fwd_streamed")
    return ao, o, stats


def attention_bwd_streamed(qkv, amask, o, stats, dao, cd, *, scale=None):
    """``attention_bwd_streamed_plain`` on CPU tensors, the streamed kernel on
    CUDA: (dqkv fp32, dqkv in cd)."""
    if qkv.device.type == "cpu":
        return attention_bwd_streamed_plain(qkv, amask, o, stats, dao, cd, scale=scale)
    cuda_only("attention_bwd_streamed", qkv)
    b, h, s, _ = stats.shape
    e, d, scale = _attention_dims(qkv, h, scale)
    dqkv = torch.empty_like(qkv)
    dqkv_c = torch.empty(qkv.shape, dtype=cd, device=qkv.device)
    rc = bwd_lib().sasrec_attention_bwd_streamed(
        qkv.data_ptr(), amask.data_ptr(), o.data_ptr(), stats.data_ptr(), dao.data_ptr(),
        dqkv.data_ptr(), dqkv_c.data_ptr(), b, s, e, h, d, scale, int(cd == torch.bfloat16),
        stream_of(qkv))
    build.check(rc, "attention_bwd_streamed")
    return dqkv, dqkv_c


_SUM_MODES = {"sum": 0, "ln": 1, "gate": 2}


def column_sums(g, mode="sum", *, x=None, seed=None, rate=0.0, layer=0, branch=0, cd=None,
                chunk=None, token0=0):
    """``column_sums_plain`` on CPU tensors, the kernel on CUDA."""
    kw = dict(x=x, seed=seed, rate=rate, layer=layer, branch=branch, cd=cd, chunk=chunk,
              token0=token0)
    if g.device.type == "cpu":
        return column_sums_plain(g, mode, **kw)
    cuda_only("column_sums", g)
    n, c = g.shape
    chunk = chunk or n
    z = -(-n // chunk)
    part = torch.empty(z, c, device=g.device)
    part2 = torch.empty(z, c, device=g.device) if mode == "ln" else None
    gated = torch.empty(n, c, dtype=cd, device=g.device) if mode == "gate" else None
    rc = bwd_lib().sasrec_column_sums(
        _SUM_MODES[mode], g.data_ptr(), ptr(x), ptr(gated), *dropout_args(seed, rate, token0),
        layer, branch, n, c, z, chunk, part.data_ptr(), ptr(part2), int(cd == torch.bfloat16),
        stream_of(g))
    build.check(rc, f"column_sums {mode}")
    return (part, part2) if mode == "ln" else (part, gated) if mode == "gate" else part


def reduce_partials(part):
    """``reduce_partials_plain`` on CPU tensors, the kernel on CUDA."""
    if part.device.type == "cpu":
        return reduce_partials_plain(part)
    z, n = part.shape
    out = torch.empty(n, device=part.device)
    rc = bwd_lib().sasrec_reduce_partials(part.data_ptr(), z, n, out.data_ptr(), stream_of(part))
    build.check(rc, "reduce_partials")
    return out
