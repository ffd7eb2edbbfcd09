"""The yardstick: the H100's peaks, the least time a call could take, each
hand-written kernel's operations and bytes from its shapes, the table
gradient's shapes in a step, and the model's operations an example.

Frozen here so that a later change to the program cannot move it. The
formulas are chip_smoke.py's (``bound``, ``mm_timing``, ``encoder_timing``,
``encoder_bwd_timing``, ``attention_timing``, ``table_grad_timing``,
``tg_step_shapes``), counted at the true widths (SASRec's E = 50, not the
kernels' padded 64): each input read once and each output written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# dense bf16 and TF32 tensor-core rates, fp32 FMA on the CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
ROW_ALIGN = 128  # the port's tables are padded to a multiple of 128 rows


def bound(nbytes: float, ops: float, fp32_ops: float = 0.0) -> dict:
    """The least time the card could take, ms: bytes at the HBM rate, or the
    operations, whichever is longer. ``ops`` run at the bf16 tensor rate;
    ``fp32_ops`` (work held at fp32 accuracy: the encoder's attention) take
    the faster of two ways: on the CUDA cores at the fp32 rate beside the
    tensor cores' work, or as 3xTF32 (three TF32 operations an fp32 one)
    after it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = min(max(ops / PEAK_FLOPS["bfloat16"], fp32_ops / PEAK_FLOPS["float32"]),
                ops / PEAK_FLOPS["bfloat16"] + 3 * fp32_ops / PEAK_FLOPS["tf32"]) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rounded_rows(vocab: int) -> int:
    return -(-vocab // ROW_ALIGN) * ROW_ALIGN


def _senet_numel(f: int) -> int:
    r = max(1, f // 2)
    return f * r + r + r * f + f


def _cdim(f: int, e: int) -> int:
    return (f + f * (f - 1) // 2) * e


def interaction_fwd(b: int, f: int, e: int, btype: str = "all") -> tuple[int, int]:
    """(bytes, ops) of ``interaction_fwd``: x (bf16) and the weights read,
    the fp32 concat written; the F-1 projections the pairs use."""
    nq = 1 if btype == "all" else f - 1
    w_bytes = 4 * _senet_numel(f) + 2 * nq * e * e
    return 2 * b * f * e + w_bytes + 4 * b * _cdim(f, e), 2 * b * (f - 1) * e * e


def fused_score(b: int, f: int, e: int, h1: int, h2: int, btype: str = "all") -> tuple[int, int]:
    """(bytes, ops) of ``score_fwd``: the interaction front, the two tower
    layers and the head, bf16 weights and fp32 biases, one fp32 output a row."""
    nq = 1 if btype == "all" else f - 1
    cdim = _cdim(f, e)
    w_bytes = 4 * _senet_numel(f) + 2 * nq * e * e
    tower = 2 * (cdim * h1 + h1 * h2 + h2) + 4 * (h1 + h2 + 1)
    ops = 2 * b * (f - 1) * e * e + 2 * b * (cdim * h1 + h1 * h2 + h2)
    return 2 * b * f * e + w_bytes + tower + 4 * b, ops


def interaction_bwd(b: int, f: int, e: int, btype: str = "all") -> tuple[int, int]:
    """(bytes, ops) of ``interaction_bwd``: g (fp32) read, x read, dx
    written, the weights read and their fp32 gradients written; v, dv W^T
    and s^T dv for F-1 fields."""
    nq = 1 if btype == "all" else f - 1
    sw = _senet_numel(f)
    nbytes = (4 * b * _cdim(f, e) + 2 * 2 * b * f * e + 4 * sw + 2 * nq * e * e
              + 4 * (nq * e * e + sw))
    return nbytes, 6 * b * (f - 1) * e * e


def _encoder_weights(e: int, layers: int) -> tuple[int, int]:
    """(matrix elements, vector elements) of the encoder's 12 stacked weights."""
    mats = (3 * e * e + e * e + 4 * e * e + 4 * e * e) * layers
    vecs = (3 * e + e + 2 * e + 4 * e + e + 2 * e) * layers
    return mats, vecs


def encoder_fwd(b: int, s: int, e: int, layers: int) -> tuple[int, int, int]:
    """(bytes, bf16 ops, fp32 ops) of one ``encode_fwd`` call: x (bf16) read
    and the output written, the additive mask, the weights; the four weight
    products at the bf16 rate, the attention (q k^T and p v, 4 S^2 D a
    head) at fp32 accuracy."""
    tokens = b * s
    mats, vecs = _encoder_weights(e, layers)
    nbytes = 2 * 2 * tokens * e + 4 * b * s + 2 * mats + 4 * vecs
    return nbytes, 2 * tokens * 12 * e * e * layers, 4 * tokens * s * e * layers


def encoder_bwd(b: int, s: int, e: int, layers: int) -> tuple[int, int, int]:
    """(bytes, bf16 ops, fp32 ops) of one ``encode_bwd`` call, which
    recomputes the forward: x and g read, dx written, the weights read and
    their fp32 gradients written; three products a weight product; the
    attention's q k^T and p v of the recomputed forward, then dP, dV, dQ
    and dK (q k^T counted once), 12 S^2 D a head."""
    tokens = b * s
    mats, vecs = _encoder_weights(e, layers)
    nbytes = 3 * 2 * tokens * e + 4 * b * s + 2 * mats + 4 * vecs + 4 * (mats + vecs)
    return nbytes, 3 * 2 * tokens * 12 * e * e * layers, 12 * tokens * s * e * layers


def attention_fwd(b: int, s: int, e: int, heads: int) -> tuple[int, int]:
    """(bytes, fp32 ops) of one layer's attention forward: qkv (fp32) and
    the mask read, the output (bf16 and fp32) and each query's (m, l)
    written; 4 S^2 D a head."""
    tokens = b * s
    nbytes = 4 * tokens * 3 * e + 4 * b * s + (2 + 4) * tokens * e + 8 * b * heads * s
    return nbytes, 4 * tokens * s * e


def attention_bwd(b: int, s: int, e: int, heads: int) -> tuple[int, int]:
    """(bytes, fp32 ops) of one layer's attention in the backward call: the
    recomputed forward and the backward, 12 S^2 D a head (as
    ``encoder_bwd``); bytes: the forward's, and qkv, the mask, o and dO,
    (m, l) read and dqkv (fp32 and bf16) written."""
    tokens = b * s
    fwd_bytes, _ = attention_fwd(b, s, e, heads)
    nbytes = (fwd_bytes + 4 * tokens * 3 * e + 4 * b * s + 2 * 4 * tokens * e
              + 8 * b * heads * s + (4 + 2) * tokens * 3 * e)
    return nbytes, 12 * tokens * s * e


def attention_bound_ms(nbytes: int, fp32_ops: int) -> float:
    """The attention's least time alone: bytes, or its fp32 work the faster
    way (3xTF32 on the tensor cores, or fp32 on the CUDA cores)."""
    t_ops = min(fp32_ops / PEAK_FLOPS["float32"], 3 * fp32_ops / PEAK_FLOPS["tf32"])
    return max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3


def table_grad(n_ids: int, rows: int, e: int) -> int:
    """Bytes of one ``table_grad`` call: the ids read once (8 B), the
    cotangents once, the gradient written once."""
    return 8 * n_ids + 4 * e * (n_ids + rows)


def tg_step_shapes(sizes: dict, rows: int) -> list[tuple[int, int, int]]:
    """(ids, gradient rows, E) of each ``table_grad`` call in one dense-table
    train step on ``rows`` rows: one a table over its features' ids, into
    the table's rows plus the one cut-off row. MicroLens, in field order:
    the level table (likes_level and views_level), the item table (item_id
    and item_seq)."""
    e, s = sizes["embedding_dim"], sizes["max_len"]
    return [(2 * rows, rounded_rows(sizes["cate_vocab"]) + 1, e),
            (rows * (1 + s), rounded_rows(sizes["item_vocab"]) + 1, e)]


def model_flops_per_example(sizes: dict) -> int:
    """The eval forward's operations an example at the published widths,
    counted from the model's equations whatever implements them: the item
    vector's projection, the SASRec encoder and the target pooling (SASRec
    models), the SENet, the bilinear projections (F-1 of them) and pair
    products, the tower. Elementwise work other than the pair products is
    left out. A training example is three times this (forward, and the
    backward's two products a product)."""
    e, f = sizes["embedding_dim"], sizes["fields"]
    h1, h2 = sizes["hidden_units"]
    p = f * (f - 1) // 2
    r = max(1, f // sizes["senet_reduction"])
    flops = 2 * sizes["mm_dim"] * e  # item_emb_d128's projection
    flops += 2 * (f * r + r * f)  # SENet
    flops += 2 * (f - 1) * e * e + p * e  # bilinear "all": x_j W, then x_i * v_j
    flops += 2 * ((f + p) * e * h1 + h1 * h2 + h2)  # the tower
    if sizes.get("seq_pooling") == "attention":
        s, layers = sizes["max_len"], sizes["attn_num_layers"]
        flops += layers * s * (2 * 12 * e * e + 4 * s * e)  # projections, FFN, attention
        flops += 2 * e * e + 4 * s * e  # target pooling: the query, the logits, the pooled sum
    return flops
