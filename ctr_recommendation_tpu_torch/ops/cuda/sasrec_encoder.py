"""Kernel 3: the SASRec encoder forward (csrc/sasrec_encoder.cu).

Replaces ctr_recommendation_tpu/ops/pallas/sasrec_encoder.py::_fwd_kernel
(:220), reached through ``fused_encode`` (:621). Eval only: the backward
kernel (``_bwd_kernel``, :238) and the in-kernel dropout come with the
``sasrec_fibinet`` training slice (ROADMAP.md queue 2 item 5).

Bound on an H100: operations. At B=8192, S=20, E=128, one layer, the
forward is 66.1 GFLOP against ~85 MB moved. A block owns whole histories
(attention needs all S steps of one) and keeps their fp32 stream in shared
memory for every layer; the weights (384 KB a layer in bf16, more than a
block's 227 KB) are staged from L2 one column block at a time, and the FFN
hidden is made and consumed E columns at a time. fp32 FMA on the CUDA cores.

Precision contract (the TPU kernel's, ``sasrec_encoder.py:61-67``,
``:159-161``, ``:164-235``), kept by the kernel and by ``encode_fwd_plain``:
the stream is fp32 (x upcast once, the output rounded once to x's dtype cd);
LayerNorm is fp32 with the biased variance and eps 1e-6; the four weight
products take operands rounded to cd and accumulate in fp32, biases fp32;
attention is fp32 throughout (qkv is not rounded), logits scaled by
1/sqrt(D) plus the additive fp32 mask (-1e9 at pad keys); pad rows are not
re-zeroed between layers (``fused_encode`` zeroes them on output).

``encode_fwd`` is the wrapper: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs ``encode_fwd_plain``. Its ``launches``
attribute counts kernel launches. The kernel's envelope: 1 <= S <= 32,
E % 32 == 0, 32 <= E <= 128, E % H == 0, L >= 1, bf16 or fp32.
"""

from __future__ import annotations

import ctypes

import torch

from ctr_recommendation_tpu_torch.ops.attention import NEG_INF, layer_norm
from ctr_recommendation_tpu_torch.ops.cuda import build
from ctr_recommendation_tpu_torch.ops.cuda.interaction import check_kernel_args

MAX_S = 32
WEIGHT_NAMES = (
    "qkv_w", "qkv_b", "proj_w", "proj_b", "ln1_s", "ln1_b",
    "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b", "ln2_s", "ln2_b",
)
_MATRICES = ("qkv_w", "proj_w", "ffn1_w", "ffn2_w")


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


def encode_fwd_plain(
    x, amask, qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b,
    ffn1_w, ffn1_b, ffn2_w, ffn2_b, ln2_s, ln2_b, *, num_heads,
):
    """Plain PyTorch version at the kernel's rounding points: x (B, S, E) in
    cd, amask (B, S) fp32 additive -> (B, S, E) in cd."""
    cd = x.dtype
    b, s, e = x.shape
    d = e // num_heads
    scale = 1.0 / d**0.5

    def mm(a, w):  # operands rounded to cd, fp32 accumulation
        return a.to(cd).float() @ w.to(cd).float()

    mask = amask.float()[:, None, None, :]
    h = x.float()
    for li in range(qkv_w.shape[0]):
        qkv = mm(layer_norm(h, ln1_s[li], ln1_b[li]), qkv_w[li]) + qkv_b[li]
        q, k, v = (t.reshape(b, s, num_heads, d).transpose(1, 2) for t in qkv.split(e, -1))
        p = torch.softmax(q @ k.transpose(-1, -2) * scale + mask, dim=-1)
        ao = (p @ v).transpose(1, 2).reshape(b, s, e)
        h = h + (mm(ao, proj_w[li]) + proj_b[li])
        f1 = torch.relu(mm(layer_norm(h, ln2_s[li], ln2_b[li]), ffn1_w[li]) + ffn1_b[li])
        h = h + (mm(f1, ffn2_w[li]) + ffn2_b[li])
    return h.to(cd)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("sasrec_encoder")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.sasrec_encode_fwd.argtypes = [vp] * 15 + [i] * 5 + [ctypes.c_float, i, vp]
        lib.sasrec_encode_fwd.restype = i
        lib.sasrec_encode_tile.argtypes = [i, i]
        lib.sasrec_encode_tile.restype = i
        _LIB = lib
    return _LIB


def encode_fwd(x, amask, *weights, num_heads):
    """x (B, S, E) bf16/fp32, the pos-embedded history with pad rows zeroed;
    amask (B, S) fp32, -1e9 at pad keys; the 12 operands of
    ``stack_weights`` -> the encoded history (B, S, E) in x's dtype (pad rows
    hold what the layers left there)."""
    if x.device.type == "cpu":
        return encode_fwd_plain(x, amask, *weights, num_heads=num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"encode_fwd runs on CUDA or CPU tensors, got {x.device}")
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
    check_kernel_args(
        {"x": (x, None), "amask": (amask, f32),
         **{n: (t, None if n in _MATRICES else f32) for n, t in zip(WEIGHT_NAMES, weights)}},
        x.dtype, x.device,
    )
    out = torch.empty_like(x)
    if b == 0:
        return out
    lib = _lib()
    if lib.sasrec_encode_tile(s, e) < 1:
        raise ValueError(f"encode_fwd: one history does not fit a block at S={s}, E={e}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.sasrec_encode_fwd(
        x.data_ptr(), amask.data_ptr(), *(t.data_ptr() for t in weights), out.data_ptr(),
        b, s, e, num_heads, layers, 1.0 / (e // num_heads) ** 0.5,
        int(x.dtype == torch.bfloat16), stream,
    )
    build.check(rc, "encode_fwd")
    encode_fwd.launches += 1
    return out


encode_fwd.launches = 0


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
) -> torch.Tensor:
    """The JAX package's ``fused_encode``, eval only: seq_emb (B, S, E),
    seq_ids (B, S) -> encoded (B, S, E) in seq_emb's dtype (bf16 or fp32),
    pad rows zero."""
    if train and dropout_rate > 0.0:
        raise NotImplementedError(
            "fused_encode with dropout (train=True, dropout_rate > 0) is not ported yet: "
            "it comes with the sasrec_fibinet training slice (ROADMAP.md queue 2 item 5)"
        )
    x, amask, pad = encoder_inputs(params, seq_emb, seq_ids, pad_id)
    out = encode_fwd(x, amask, *stack_weights(params, x.dtype), num_heads=num_heads)
    return torch.where(pad[..., None], torch.zeros((), dtype=out.dtype, device=out.device), out)
