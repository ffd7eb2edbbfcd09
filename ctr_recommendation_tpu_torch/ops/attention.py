"""Attention pooling over the click history: SASRec-style and DIN.

The JAX package's ``ops/attention.py`` on the port: learned positional
embeddings + N pre-LayerNorm transformer blocks (MHSA + pointwise FFN) over
the history, then target-aware pooling, where the candidate item queries
the encoded history. ``encode`` computes in the activation dtype, LayerNorm
and softmax included, exactly as the JAX ``encode`` does; it is the oracle
for ``use_pallas=False``. The kernel path (``ops/cuda/sasrec_encoder.py``)
keeps the stream, LayerNorm and attention in fp32 instead.

Pad steps are masked with -1e9 before the softmax (never -inf, so a history
that is all pad stays finite); ``target_pool`` gives zeros for such a row.

``din_init`` / ``din_pool``: DIN's local activation unit (Zhou et al. 2018),
which scores each history item against the candidate and pools with the raw,
un-normalized weights.
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.ops.initializers import linear_apply, linear_init

NEG_INF = -1e9
LN_EPS = 1e-6


def init(
    gen: torch.Generator,
    emb_dim: int,
    max_len: int,
    num_heads: int = 2,
    num_layers: int = 1,
) -> dict:
    """pos_emb 0.02 N(0, 1) (max_len, E); per block qkv (E, 3E) laid out
    [q | k | v], proj (E, E), ffn1 (E, 4E), ffn2 (4E, E), two LayerNorms;
    then pool_q (E, E). ``blocks`` is a list, as in JAX."""
    if emb_dim % num_heads:
        raise ValueError(f"emb_dim {emb_dim} not divisible by num_heads {num_heads}")
    params: dict = {
        "pos_emb": 0.02 * torch.randn(max_len, emb_dim, generator=gen),
        "blocks": [],
    }
    for _ in range(num_layers):
        params["blocks"].append({
            "qkv": linear_init(gen, emb_dim, 3 * emb_dim),
            "proj": linear_init(gen, emb_dim, emb_dim),
            "ln1_scale": torch.ones(emb_dim),
            "ln1_bias": torch.zeros(emb_dim),
            "ffn1": linear_init(gen, emb_dim, 4 * emb_dim),
            "ffn2": linear_init(gen, 4 * emb_dim, emb_dim),
            "ln2_scale": torch.ones(emb_dim),
            "ln2_bias": torch.zeros(emb_dim),
        })
    params["pool_q"] = linear_init(gen, emb_dim, emb_dim)
    return params


def layer_norm(x, scale, bias, eps=LN_EPS):
    """Biased variance; computed in x's dtype (the parameters promote the
    affine part to fp32, as in JAX)."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _sqrt(n: int, dtype: torch.dtype) -> torch.Tensor:
    """sqrt(n) taken in fp32 and cast to ``dtype``, as ``jnp.sqrt(n).astype``."""
    return torch.sqrt(torch.tensor(float(n))).to(dtype)


def _mhsa(block, h, pad_mask, num_heads):
    b, s, e = h.shape
    d = e // num_heads
    qkv = linear_apply(block["qkv"], h).reshape(b, s, 3, num_heads, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, S, H, D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / _sqrt(d, h.dtype)
    logits = logits.masked_fill(pad_mask[:, None, None, :], NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, s, e)
    return linear_apply(block["proj"], out)


def encode(
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
    """seq_emb (B, S, E), seq_ids (B, S) -> encoded history (B, S, E). Pad
    rows are zeroed before the first layer and after each. With ``train``,
    ``dropout_rate`` > 0 and a ``seed`` (int64 tensor (1,)), each block's
    attention and FFN outputs are dropped where the JAX ``encode`` drops
    them, with the masks of the kernel path (``sasrec_encoder.dropout_mask``,
    sites (layer, 0) and (layer, 1), tokens counted from ``token0``), kept
    values divided by 1 - rate."""
    from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import dropout_mask

    b, s, e = seq_emb.shape
    pad_mask = seq_ids == pad_id
    zero = torch.zeros((), dtype=seq_emb.dtype, device=seq_emb.device)
    drop_on = train and dropout_rate > 0.0 and seed is not None

    def dropout(a, li, branch):
        if not drop_on:
            return a
        keep = dropout_mask(seed, b * s, e, li, branch, dropout_rate, token0).reshape(b, s, e)
        return torch.where(keep, a / (1.0 - dropout_rate), torch.zeros((), dtype=a.dtype,
                                                                       device=a.device))

    h = seq_emb + params["pos_emb"][:s].to(seq_emb.dtype)
    h = torch.where(pad_mask[..., None], zero, h)
    for li, block in enumerate(params["blocks"]):
        hn = layer_norm(h, block["ln1_scale"], block["ln1_bias"]).to(h.dtype)
        h = h + dropout(_mhsa(block, hn, pad_mask, num_heads), li, 0)
        hn = layer_norm(h, block["ln2_scale"], block["ln2_bias"]).to(h.dtype)
        f = linear_apply(block["ffn2"], torch.relu(linear_apply(block["ffn1"], hn)))
        h = h + dropout(f, li, 1)
        h = torch.where(pad_mask[..., None], zero, h)
    return h


def target_pool(
    params: dict,
    encoded: torch.Tensor,
    seq_ids: torch.Tensor,
    target_emb: torch.Tensor,
    *,
    pad_id: int = 0,
) -> torch.Tensor:
    """The candidate item queries the encoded history: encoded (B, S, E),
    target_emb (B, E) -> (B, E) in encoded's dtype. All-pad rows -> zeros."""
    e = encoded.shape[-1]
    q = linear_apply(params["pool_q"], target_emb)  # (B, E)
    logits = torch.einsum("be,bse->bs", q, encoded) / _sqrt(e, encoded.dtype)
    pad_mask = seq_ids == pad_id
    logits = logits.masked_fill(pad_mask, NEG_INF)
    attn = torch.softmax(logits, dim=-1)
    pooled = torch.einsum("bs,bse->be", attn, encoded)
    any_real = (~pad_mask).any(-1, keepdim=True)
    return torch.where(any_real, pooled, torch.zeros((), dtype=pooled.dtype, device=pooled.device))


def din_init(gen: torch.Generator, emb_dim: int, hidden_units=(64, 32)) -> dict:
    """DIN's local activation unit: an MLP over ``[h, h*t, h-t, t]`` (4E
    wide) to one logit a history position. Hidden layers are PReLU with a
    per-unit slope ``alpha`` starting at 0.25; the last layer is linear."""
    dims = (4 * emb_dim, *hidden_units, 1)
    layers = []
    for i in range(len(dims) - 1):
        layer = {"lin": linear_init(gen, dims[i], dims[i + 1])}
        if i < len(dims) - 2:
            layer["alpha"] = torch.full((dims[i + 1],), 0.25)
        layers.append(layer)
    return {"layers": layers}


def din_pool(
    params: dict,
    seq_emb: torch.Tensor,
    seq_ids: torch.Tensor,
    target_emb: torch.Tensor,
    *,
    pad_id: int = 0,
) -> torch.Tensor:
    """seq_emb (B, S, E), seq_ids (B, S), target_emb (B, E) -> (B, E), all in
    seq_emb's dtype: sum_s w_s h_s with w from the activation unit, NOT
    softmax-normalized (the paper keeps the raw weights, §4.3). Pad
    positions weigh 0, so an all-pad history pools to zeros."""
    t = target_emb[:, None, :].expand_as(seq_emb)
    z = torch.cat([seq_emb, seq_emb * t, seq_emb - t, t], dim=-1)
    layers = params["layers"]
    for layer in layers[:-1]:
        z = linear_apply(layer["lin"], z)
        z = torch.where(z >= 0, z, layer["alpha"].to(z.dtype) * z)  # PReLU
    w = linear_apply(layers[-1]["lin"], z)[..., 0]  # (B, S)
    w = w.masked_fill(seq_ids == pad_id, 0.0).to(seq_emb.dtype)
    return torch.einsum("bs,bse->be", w, seq_emb)
