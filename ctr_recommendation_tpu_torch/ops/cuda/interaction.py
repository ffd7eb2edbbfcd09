"""The fused SENet + bilinear + concat block on hand-written kernels.

Forward (csrc/interaction.cu) replaces ctr_recommendation_tpu/ops/pallas/
interaction.py::_kernel_all (:56) and ::_kernel_each (:94); backward
(csrc/interaction_bwd.cu) replaces ::_bwd_kernel (:250). Both are reached
through ``fused_senet_bilinear_concat`` (:566), whose ``jax.custom_vjp``
becomes the ``FusedInteraction`` autograd Function here.

Bound on an H100: bytes, both ways. At B=8192, F=6, E=128 with bf16 input
the forward must read 12.6 MB and write 88 MB of fp32 output; at B=4096 the
backward must read g (44 MB fp32) and x and write dx (56.6 MB in all). The
forward keeps x and S in shared memory with the projection weight staged in
column blocks, holds each V tile in registers and writes every output
element once with coalesced 16-byte stores; the backward streams g once and
reduces the weight gradients through per-block partials (no atomics:
bit-identical repeats).

Envelope of both kernels: F >= 2, E % 8 == 0, and a row tile of 4 that fits
a block's shared memory; that covers E=256 (every configuration of the JAX
package's recipe sweep) in bf16 and fp32. Outside it the wrappers raise
``ValueError`` naming the envelope.

``interaction_fwd`` and ``interaction_bwd`` are the wrappers: on a CUDA
tensor each launches its kernel (or raises), on a CPU tensor it runs its
plain PyTorch version (``interaction_fwd_plain``, ``interaction_bwd_plain``)
with the same rounding points. Their ``launches`` attributes count kernel
launches (the backward counts two a call: the kernel and its reduction).
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


_LIB = None


def _kernel_lib():
    global _LIB
    if _LIB is None:
        lib = build.load("interaction")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.interaction_fwd.argtypes = [vp] * 7 + [i] * 6 + [vp]
        lib.interaction_fwd.restype = i
        lib.interaction_fwd_tile_rows.argtypes = [i] * 4
        lib.interaction_fwd_tile_rows.restype = i
        _LIB = lib
    return _LIB


ENVELOPE = "F >= 2, E % 8 == 0 and a row tile of 4 within a block's 227 KB of shared memory"


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def is_bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


def cuda_only(what, t) -> None:
    """Raise unless t, a wrapper's operand past its CPU branch, is a bf16 or
    fp32 CUDA tensor."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {t.device}")
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: operands must be bfloat16 or float32, got {t.dtype}")


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
        raise ValueError(f"interaction_fwd needs {ENVELOPE}; got F={f}, E={e}")
    if (
        tuple(w1.shape) != (f, r) or tuple(b1.shape) != (r,)
        or tuple(w2.shape) != (r, f) or tuple(b2.shape) != (f,)
        or tuple(w_bi.shape) != wbi_shape
    ):
        raise ValueError("SENet / bilinear weight shapes do not match x")
    lib = _kernel_lib()
    bf16 = is_bf16(x)
    if lib.interaction_fwd_tile_rows(f, e, r, bf16) == 0:
        raise ValueError(f"interaction_fwd needs {ENVELOPE}; got F={f}, E={e}, {x.dtype}")
    f32 = torch.float32
    check_kernel_args(
        {"x": (x, None), "w1": (w1, f32), "b1": (b1, f32), "w2": (w2, f32),
         "b2": (b2, f32), "w_bi": (w_bi, None)},
        x.dtype, x.device,
    )
    out = torch.empty(b, (f + f * (f - 1) // 2) * e, dtype=f32, device=x.device)
    if b == 0:
        return out
    rc = lib.interaction_fwd(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w_bi.data_ptr(), out.data_ptr(), b, f, e, r, bf16, int(bilinear_type == "each"),
        stream_of(x),
    )
    build.check(rc, "interaction_fwd")
    interaction_fwd.launches += 1
    return out


interaction_fwd.launches = 0


def interaction_bwd_plain(g, x, w1, b1, w2, b2, w_bi, *, bilinear_type="all",
                          forward_rounding=False):
    """Plain PyTorch version of the backward, at the TPU backward kernel's
    rounding points (not autograd of ``interaction_fwd_plain``): s and v stay
    fp32, and only the operands of the E x E products (s, dv, W) take x's
    dtype cd. Returns (dx in cd, dW1, db1, dW2, db2, dW_bi), all weight
    gradients fp32 and summed over the batch.

    ``forward_rounding=True`` recomputes s and v at the forward's rounding
    points instead (s = cd(x * cd(gate)), v = cd(s W)): a wrong backward that
    the bf16 tolerances of the checks must reject. In fp32 the two agree."""
    cd = x.dtype
    b, f, e = x.shape
    xs = x.float()
    g = g.float()
    z = xs.mean(-1)
    h1 = z @ w1.float() + b1.float()
    a = torch.relu(h1)
    w = torch.sigmoid(a @ w2.float() + b2.float())
    s = (x * w.to(cd)[..., None]).float() if forward_rounding else xs * w[..., None]
    s_cd = s.to(cd).float()
    wf = w_bi.to(cd).float()
    i_idx, j_idx = (torch.as_tensor(t, device=x.device) for t in pair_indices(f))
    ds = g[:, : f * e].reshape(b, f, e).clone()
    gp = g[:, f * e :].reshape(b, -1, e)
    dv = torch.zeros_like(s)

    def project(v):
        return v.to(cd).float() if forward_rounding else v

    if bilinear_type == "all":
        v = project(s_cd @ wf)
        ds.index_add_(1, i_idx, gp * v[:, j_idx])
        dv.index_add_(1, j_idx, gp * s[:, i_idx])
        dv_cd = dv.to(cd).float()
        dw_bi = torch.einsum("bfe,bfd->ed", s_cd, dv_cd)
        ds = ds + dv_cd @ wf.T
    elif bilinear_type == "each":
        v = project(torch.einsum("bfe,fed->bfd", s_cd[:, :-1], wf))
        dv[:, :-1].index_add_(1, i_idx, gp * s[:, j_idx])
        ds.index_add_(1, j_idx, gp * v[:, i_idx])
        dv_cd = dv[:, :-1].to(cd).float()
        dw_bi = torch.einsum("bfe,bfd->fed", s_cd[:, :-1], dv_cd)
        ds[:, :-1] += torch.einsum("bfd,fed->bfe", dv_cd, wf)
    else:
        raise ValueError(f"bilinear_type must be 'all' or 'each', got {bilinear_type!r}")
    dh2 = (ds * xs).sum(-1) * w * (1.0 - w)
    dh1 = (dh2 @ w2.float().T) * (h1 > 0)
    dz = dh1 @ w1.float().T
    dx = ds * w[..., None] + dz[..., None] * (1.0 / e)
    return dx.to(cd), z.T @ dh1, dh1.sum(0), a.T @ dh2, dh2.sum(0), dw_bi


_BWD = None


def _bwd_fns():
    global _BWD
    if _BWD is None:
        lib = build.load("interaction_bwd")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.interaction_bwd.argtypes = [vp] * 10 + [i] * 8 + [vp]
        lib.interaction_bwd.restype = i
        lib.interaction_bwd_tile_rows.argtypes = [i] * 5
        lib.interaction_bwd_tile_rows.restype = i
        _BWD = lib
    return _BWD


def interaction_bwd(g, x, w1, b1, w2, b2, w_bi, *, bilinear_type="all"):
    """g (B, (F + F(F-1)/2) * E) fp32 and the forward's operands (x and w_bi
    in the compute dtype, SENet weights fp32) -> (dx, dW1, db1, dW2, db2,
    dW_bi): dx in x's dtype, the weight gradients fp32."""
    if x.device.type == "cpu":
        return interaction_bwd_plain(g, x, w1, b1, w2, b2, w_bi, bilinear_type=bilinear_type)
    if x.device.type != "cuda":
        raise ValueError(f"interaction_bwd runs on CUDA or CPU tensors, got {x.device}")
    if bilinear_type not in ("all", "each"):
        raise ValueError(f"bilinear_type must be 'all' or 'each', got {bilinear_type!r}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    b, f, e = x.shape
    r = w1.shape[1]
    p = f * (f - 1) // 2
    each = bilinear_type == "each"
    wbi_shape = (f - 1, e, e) if each else (e, e)
    if f < 2 or e % 8:
        raise ValueError(f"interaction_bwd needs {ENVELOPE}; got F={f}, E={e}")
    if (
        tuple(g.shape) != (b, (f + p) * e)
        or tuple(w1.shape) != (f, r) or tuple(b1.shape) != (r,)
        or tuple(w2.shape) != (r, f) or tuple(b2.shape) != (f,)
        or tuple(w_bi.shape) != wbi_shape
    ):
        raise ValueError("cotangent / SENet / bilinear weight shapes do not match x")
    f32 = torch.float32
    check_kernel_args(
        {"g": (g, f32), "x": (x, None), "w1": (w1, f32), "b1": (b1, f32),
         "w2": (w2, f32), "b2": (b2, f32), "w_bi": (w_bi, None)},
        x.dtype, x.device,
    )
    nq = f - 1 if each else 1
    sizes = [nq * e * e, f * r, r, r * f, f]
    n = sum(sizes)
    out = torch.empty(n, dtype=f32, device=x.device)
    dx = torch.empty_like(x)
    if b > 0:
        lib = _bwd_fns()
        bf16 = is_bf16(x)
        tb = lib.interaction_bwd_tile_rows(f, e, r, bf16, int(each))
        if tb < 4:
            raise ValueError(f"interaction_bwd needs {ENVELOPE}; got F={f}, E={e}, {x.dtype}")
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        grid = min(-(-b // tb), sms)
        stride = -(-n // 4) * 4
        part = torch.empty(grid * stride, dtype=f32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.interaction_bwd(
            g.data_ptr(), x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w_bi.data_ptr(), dx.data_ptr(), part.data_ptr(), out.data_ptr(),
            b, f, e, r, bf16, int(each), grid, stride, stream,
        )
        build.check(rc, "interaction_bwd")
        interaction_bwd.launches += 2  # the kernel and the partials' reduction
    else:
        out.zero_()
    dw_bi, dw1, db1, dw2, db2 = torch.split(out, sizes)
    return dx, dw1.view(f, r), db1, dw2.view(r, f), db2, dw_bi.view(wbi_shape)


interaction_bwd.launches = 0


class FusedInteraction(torch.autograd.Function):
    """The block with the kernels both ways, as ``jax.custom_vjp`` wraps the
    TPU kernels: it takes the fp32 master weights and returns fp32 weight
    gradients; the cast of W to the compute dtype happens inside, and x (not
    the output) is kept for the backward, which recomputes the rest."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w_bi, bilinear_type):
        w_cd = w_bi.to(x.dtype).contiguous()
        ctx.save_for_backward(x, w1, b1, w2, b2, w_cd)
        ctx.bilinear_type = bilinear_type
        return interaction_fwd(x, w1, b1, w2, b2, w_cd, bilinear_type=bilinear_type)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, w_cd = ctx.saved_tensors
        grads = interaction_bwd(
            g.float().contiguous(), x, w1, b1, w2, b2, w_cd, bilinear_type=ctx.bilinear_type
        )
        return (*grads, None)


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
    """The JAX package's entry point of the same name, on the kernels through
    ``FusedInteraction`` (train and eval alike): the compute dtype is x's
    (bf16 or fp32, else fp32); gradients reach the fp32 parameters."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.float()
    w_bi = bilinear_params["w"] if bilinear_type == "all" else bilinear_params["w_each"]
    w1, b1, w2, b2 = senet_weights(senet_params, x.shape[1])
    return FusedInteraction.apply(x.contiguous(), w1, b1, w2, b2, w_bi, bilinear_type)
