"""Kernel 2: fused batched scoring, interaction + folded tower (csrc/scoring.cu).

Replaces ctr_recommendation_tpu/ops/pallas/scoring.py::_kernel (:36),
reached through ``fused_score`` (:196), with its "all" and "each" bodies.

Bound on an H100: operations. At B=8192 the BatchNorm-folded tower
2688 -> 512 -> 256 -> 1 is 26 GFLOP against ~15 MB of input, output and
weights. The TPU kernel holds the (TB, 21E) concat and all of W1 in VMEM;
an H100 block has 227 KB of shared memory, so the kernel streams the concat
in E-wide chunks, each built in shared memory and multiplied at once into an
h1 accumulator held in registers, with W1 staged from L2, in column passes
of 512 h1 columns. The three tower products are fp32 FMA in the kernel;
moving them to the tensor cores is later work.

``score_fwd`` is the wrapper: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs ``score_fwd_plain``, the same function in
plain PyTorch with the same rounding points. Its ``launches`` attribute
counts kernel launches. Like the TPU kernel, it reads the tower's widths
from the weights and takes any two-layer tower; its envelope (``ENVELOPE``)
adds H1 % 32 == 0, H2 % 8 == 0, E % 32 == 0 and a row tile of 8 that fits
shared memory, which holds the recorded towers (512, 256), (1024, 512) and
(768, 384) at E=128 and 256 in bf16 and fp32.
"""

from __future__ import annotations

import ctypes

import torch

from ctr_recommendation_tpu_torch.ops.cuda import build
from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
    senet_bilinear_parts,
    check_kernel_args,
    senet_weights,
)

ENVELOPE = (
    "F >= 2, E % 32 == 0, a 2-layer tower with H1 % 32 == 0 and H2 % 8 == 0, and a row "
    "tile of 8 within a block's 227 KB of shared memory"
)


def score_fwd_plain(
    x, sw1, sb1, sw2, sb2, w_bi, w1, b1, w2, b2, w3, b3, *, bilinear_type="all"
):
    """Plain PyTorch version: x (B, F, E) in the tower dtype cd -> (B,) fp32.
    The concat is cd; every product accumulates in fp32; h1 and h2 are cast
    to cd before the next product; biases and the sigmoid are fp32."""
    b = x.shape[0]
    cd = x.dtype
    s, p = senet_bilinear_parts(x, sw1, sb1, sw2, sb2, w_bi, bilinear_type)
    c = torch.cat([s.reshape(b, -1), p.reshape(b, -1)], dim=-1)
    h1 = torch.relu(c.float() @ w1.float() + b1.float()).to(cd)
    h2 = torch.relu(h1.float() @ w2.float() + b2.float()).to(cd)
    logit = h2.float() @ w3.float() + b3.float()
    return torch.sigmoid(logit)[:, 0]


_LIB = None


def _kernel_lib():
    global _LIB
    if _LIB is None:
        lib = build.load("scoring")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_score.argtypes = [vp] * 13 + [i] * 8 + [vp]
        lib.fused_score.restype = i
        lib.fused_score_tile_rows.argtypes = [i] * 6
        lib.fused_score_tile_rows.restype = i
        _LIB = lib
    return _LIB


def score_fwd(
    x, sw1, sb1, sw2, sb2, w_bi, w1, b1, w2, b2, w3, b3, *, bilinear_type="all"
):
    """x (B, F, E) in the tower dtype (bf16/fp32); SENet weights fp32; w_bi,
    w1 (C, H1), w2 (H1, H2), w3 (H2, 1) in x's dtype; b1, b2, b3 fp32 ->
    click probabilities (B,) fp32."""
    args = (x, sw1, sb1, sw2, sb2, w_bi, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return score_fwd_plain(*args, bilinear_type=bilinear_type)
    if x.device.type != "cuda":
        raise ValueError(f"score_fwd runs on CUDA or CPU tensors, got {x.device}")
    if bilinear_type not in ("all", "each"):
        raise ValueError(f"bilinear_type must be 'all' or 'each', got {bilinear_type!r}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    b, f, e = x.shape
    r = sw1.shape[1]
    h1, h2 = w1.shape[1], w2.shape[1]
    if f < 2 or e % 32 or h1 % 32 or h2 % 8:
        raise ValueError(f"fused_score needs {ENVELOPE}; got F={f}, E={e}, tower {(h1, h2)}")
    cdim = (f + f * (f - 1) // 2) * e
    wbi_shape = (e, e) if bilinear_type == "all" else (f - 1, e, e)
    shapes = {
        "sw1": (sw1, (f, r)), "sb1": (sb1, (r,)), "sw2": (sw2, (r, f)), "sb2": (sb2, (f,)),
        "w_bi": (w_bi, wbi_shape), "w1": (w1, (cdim, h1)), "b1": (b1, (h1,)),
        "w2": (w2, (h1, h2)), "b2": (b2, (h2,)), "w3": (w3, (h2, 1)), "b3": (b3, (1,)),
    }
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
    f32 = torch.float32
    check_kernel_args(
        {"x": (x, None), "sw1": (sw1, f32), "sb1": (sb1, f32), "sw2": (sw2, f32),
         "sb2": (sb2, f32), "w_bi": (w_bi, None), "w1": (w1, None), "b1": (b1, f32),
         "w2": (w2, None), "b2": (b2, f32), "w3": (w3, None), "b3": (b3, f32)},
        x.dtype, x.device,
    )
    lib = _kernel_lib()
    is_bf16 = int(x.dtype == torch.bfloat16)
    if lib.fused_score_tile_rows(f, e, r, h1, h2, is_bf16) == 0:
        raise ValueError(
            f"fused_score needs {ENVELOPE}; got F={f}, E={e}, tower {(h1, h2)}, {x.dtype}")
    out = torch.empty(b, dtype=f32, device=x.device)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_score(
        *(t.data_ptr() for t in args), out.data_ptr(),
        b, f, e, r, h1, h2, is_bf16, int(bilinear_type == "each"), stream,
    )
    build.check(rc, "fused_score")
    score_fwd.launches += 1
    return out


score_fwd.launches = 0


def prepare_score_params(
    senet_params: dict, bilinear_params: dict, folded_mlp: dict, *,
    bilinear_type: str, compute_dtype: torch.dtype,
) -> tuple:
    """The kernel's weight operands, cast once: SENet and biases fp32, the
    bilinear and tower weights in ``compute_dtype``. ``folded_mlp`` comes
    from ops.mlp.fold_batch_norm and must have exactly 2 hidden layers."""
    if len(folded_mlp["layers"]) != 2:
        raise ValueError("fused_score expects a 2-hidden-layer tower")
    device = senet_params["fc1"]["w"].device
    f = senet_params["fc2"]["w"].shape[1]
    w_bi = bilinear_params["w"] if bilinear_type == "all" else bilinear_params["w_each"]
    l1 = folded_mlp["layers"][0]["linear"]
    l2 = folded_mlp["layers"][1]["linear"]
    l3 = folded_mlp["out"]

    def wt(t):
        return t.to(compute_dtype).contiguous()

    def bias(lin):
        if "b" in lin:
            return lin["b"].float().contiguous()
        return torch.zeros(lin["w"].shape[1], device=device)

    return (
        *senet_weights(senet_params, f), wt(w_bi),
        wt(l1["w"]), bias(l1), wt(l2["w"]), bias(l2), wt(l3["w"]), bias(l3),
    )


def fused_score(
    senet_params: dict,
    bilinear_params: dict,
    folded_mlp: dict,
    x: torch.Tensor,
    *,
    bilinear_type: str = "all",
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The JAX package's entry point of the same name: x (B, F, E) -> click
    probabilities (B,), with the tower in ``compute_dtype``."""
    weights = prepare_score_params(
        senet_params, bilinear_params, folded_mlp,
        bilinear_type=bilinear_type, compute_dtype=compute_dtype,
    )
    return score_fwd(
        x.to(compute_dtype).contiguous(), *weights, bilinear_type=bilinear_type
    )
