"""Kernel 1: fused SENet + bilinear + concat forward (csrc/interaction.cu).

Replaces ctr_recommendation_tpu/ops/pallas/interaction.py::_kernel_all (:56)
and ::_kernel_each (:94), reached through ``fused_senet_bilinear_concat``
(:566). Forward only; the hand-written backward (:250) belongs to the
training slice.

Bound on an H100: bytes. At B=8192, F=6, E=128 with bf16 input the kernel
must read 12.6 MB and write 88 MB of fp32 output; the ~1.3 GFLOP of
projection is far below the card's compute line. The kernel keeps x, S and
the projection weight in shared memory, holds each V tile in registers and
writes every output element once with coalesced 16-byte stores.

``interaction_fwd`` is the wrapper: on a CUDA tensor it launches the kernel
(or raises), on a CPU tensor it runs ``interaction_fwd_plain``, the same
function in plain PyTorch with the same rounding points. Its ``launches``
attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ctr_recommendation_tpu_torch.ops.bilinear import pair_indices
from ctr_recommendation_tpu_torch.ops.cuda import build


def senet_bilinear_parts(x, w1, b1, w2, b2, w_bi, bilinear_type):
    """(S, P) in x's dtype cd: the gate in fp32 and cast to cd before x * w;
    V = cd(S @ W) with fp32 accumulation; pairs S_i * V_j ("all") or
    V_i * S_j ("each") in triu order."""
    cd = x.dtype
    z = x.float().mean(-1)  # (B, F)
    a = torch.relu(z @ w1.float() + b1.float())
    w = torch.sigmoid(a @ w2.float() + b2.float())
    s = x * w.to(cd)[..., None]
    i_idx, j_idx = pair_indices(x.shape[1])
    if bilinear_type == "all":
        v = (s.float() @ w_bi.float()).to(cd)
        p = s[:, i_idx] * v[:, j_idx]
    elif bilinear_type == "each":
        v = torch.einsum("bfe,fed->bfd", s[:, :-1].float(), w_bi.float()).to(cd)
        p = v[:, i_idx] * s[:, j_idx]
    else:
        raise ValueError(f"bilinear_type must be 'all' or 'each', got {bilinear_type!r}")
    return s, p


def interaction_fwd_plain(x, w1, b1, w2, b2, w_bi, *, bilinear_type="all"):
    """Plain PyTorch version: x (B, F, E) -> (B, (F + F(F-1)/2) * E) fp32."""
    b = x.shape[0]
    s, p = senet_bilinear_parts(x, w1, b1, w2, b2, w_bi, bilinear_type)
    return torch.cat([s.reshape(b, -1), p.reshape(b, -1)], dim=-1).float()


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = build.load("interaction").interaction_fwd
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [i] * 6 + [vp]
        fn.restype = i
        _FN = fn
    return _FN


def check_kernel_args(tensors: dict, dtype: torch.dtype, device) -> None:
    """Device, dtype, contiguity and 16-byte alignment of kernel operands;
    ``tensors`` maps name -> (tensor, expected dtype or None for ``dtype``)."""
    for name, (t, want) in tensors.items():
        want = dtype if want is None else want
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != want:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def interaction_fwd(x, w1, b1, w2, b2, w_bi, *, bilinear_type="all"):
    """x (B, F, E) bf16/fp32; w1 (F, R), b1 (R,), w2 (R, F), b2 (F,) fp32;
    w_bi (E, E) ("all") or (F-1, E, E) ("each") in x's dtype ->
    (B, (F + F(F-1)/2) * E) fp32."""
    if x.device.type == "cpu":
        return interaction_fwd_plain(x, w1, b1, w2, b2, w_bi, bilinear_type=bilinear_type)
    if x.device.type != "cuda":
        raise ValueError(f"interaction_fwd runs on CUDA or CPU tensors, got {x.device}")
    if bilinear_type not in ("all", "each"):
        raise ValueError(f"bilinear_type must be 'all' or 'each', got {bilinear_type!r}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    b, f, e = x.shape
    r = w1.shape[1]
    wbi_shape = (e, e) if bilinear_type == "all" else (f - 1, e, e)
    if f < 2 or e % 8:
        raise ValueError(f"need F >= 2 and E % 8 == 0, got F={f}, E={e}")
    if (
        tuple(w1.shape) != (f, r) or tuple(b1.shape) != (r,)
        or tuple(w2.shape) != (r, f) or tuple(b2.shape) != (f,)
        or tuple(w_bi.shape) != wbi_shape
    ):
        raise ValueError("SENet / bilinear weight shapes do not match x")
    f32 = torch.float32
    check_kernel_args(
        {"x": (x, None), "w1": (w1, f32), "b1": (b1, f32), "w2": (w2, f32),
         "b2": (b2, f32), "w_bi": (w_bi, None)},
        x.dtype, x.device,
    )
    out = torch.empty(b, (f + f * (f - 1) // 2) * e, dtype=f32, device=x.device)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel_fn()(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w_bi.data_ptr(), out.data_ptr(), b, f, e, r,
        int(x.dtype == torch.bfloat16), int(bilinear_type == "each"), stream,
    )
    build.check(rc, "interaction_fwd")
    interaction_fwd.launches += 1
    return out


interaction_fwd.launches = 0


def senet_weights(senet_params: dict, num_fields: int):
    """(w1, b1, w2, b2) in fp32, zeros for absent biases."""
    fc1, fc2 = senet_params["fc1"], senet_params["fc2"]
    w1 = fc1["w"].float().contiguous()
    w2 = fc2["w"].float().contiguous()
    b1 = fc1["b"].float() if "b" in fc1 else torch.zeros(w1.shape[1], device=w1.device)
    b2 = fc2["b"].float() if "b" in fc2 else torch.zeros(num_fields, device=w2.device)
    return w1, b1.contiguous(), w2, b2.contiguous()


def fused_senet_bilinear_concat(
    senet_params: dict, bilinear_params: dict, x: torch.Tensor, *, bilinear_type: str = "all"
) -> torch.Tensor:
    """The JAX package's entry point of the same name, on the kernel: the
    compute dtype is x's (bf16 or fp32, else fp32)."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.float()
    w_bi = bilinear_params["w"] if bilinear_type == "all" else bilinear_params["w_each"]
    w1, b1, w2, b2 = senet_weights(senet_params, x.shape[1])
    return interaction_fwd(
        x.contiguous(), w1, b1, w2, b2, w_bi.to(x.dtype).contiguous(),
        bilinear_type=bilinear_type,
    )
