"""A tower layer's bias, BatchNorm, ReLU and dropout, both ways, on
hand-written kernels (csrc/tower.cu).

Replaces no TPU kernel: the JAX package leaves the tower to XLA
(``ops/mlp.py``). On the card the port ran it as a chain of library
kernels: the bias add, the cast to fp32, mean and var, the normalise-and-
affine, ReLU, dropout's compare, divide and select, and autograd's backward
of each. ``TowerLayer`` takes the GEMM's output y = x W (cuBLAS; the GEMMs
stay there) and computes, with fp32 inside and the tower's dtype cd (bf16 or
fp32) out:

    h = y + b; S = sum w, N = max(S, 1) (w the 0/1 row weights, 1 without);
    mean = sum w h / N, var = sum w (h - mean)^2 / N (biased);
    inv = 1 / sqrt(var + EPS), a = gamma inv, c = beta - mean a;
    z = a h + c; code = (z > 0) and (u < keep); out = code ? z s : 0, s = 1 / keep;
    running mean, var <- (1 - MOMENTUM) running + MOMENTUM (mean, var N / max(N - 1, 1)).

u are the dropout's uniforms, drawn by ``torch.rand`` as ``ops/mlp.py``
draws them (none at rate 0), keep = 1 - rate. Without BatchNorm a = 1 and
c = 0. The backward, from dout: g = code ? dout s : 0, xh = (h - mean) inv;
dbeta = sum g, dgamma = sum g xh; dh = a (g - w (dbeta + xh dgamma) (1 /
N)), the gradient through the batch statistics in closed form; db = sum dh.
dh feeds cuBLAS's dW and dx. The layer keeps y (not the normalised tensor)
and the code, one bit an element (``pack_code``), for the backward.

Five building blocks, each a wrapper with a ``launches`` counter and a plain
PyTorch version (taken for CPU tensors; fp32 inside, fp64 for fp64 tensors):

1. ``fwd_sums``: (sum w h, S), 2 launches (a column pass, the chunks' sum);
2. ``fwd_devs``: sum w (h - mean)^2, 2 launches;
3. ``fwd_apply``: out, the code and the running statistics, 1 launch;
4. ``bwd_sums``: (dbeta, dgamma) over the call's rows, 2 launches;
5. ``bwd_dx``: dh and db, 2 launches.

A layer with BatchNorm runs all five (``fwd_launches`` 5, ``bwd_launches``
4), one without runs 3 and 5 (1 and 2). In a data-parallel step (``group``)
``TowerLayer`` all-reduces the sums between the blocks, as ``ops/mlp.py``'s
statistics do: the statistics and the backward's two sums run over the
global batch, while dgamma, dbeta and db stay the rank's own, for the
trainer's gradient sum. One algorithm takes bf16 and fp32, BatchNorm or
none, any rate, weights or none, a data-parallel slice or none, any width
(``plan``: 16-byte vectors where the width allows, else one column a lane)
and any row count, none included (one empty chunk: zero sums).

Bound on an H100: bytes. No float atomics: each reduction runs in an order
fixed by (rows, n) alone (``plan``), so repeats are bit-identical.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ctr_recommendation_tpu_torch.ops.cuda import build
from ctr_recommendation_tpu_torch.ops.cuda.interaction import stream_of
from ctr_recommendation_tpu_torch.parallel import data_parallel

# csrc/tower.cu's constants
EPS = 1e-5  # kEps (ops/mlp.py's BN_EPS)
MOMENTUM = 0.1  # kMomentum (ops/mlp.py's BN_MOMENTUM)
WARPS = 8  # kWarps: warps a block, each every 8th row of the block's chunk
TARGET_BLOCKS = 528  # kTargetBlocks: blocks a pass aims at (4 an SM of an H100)
MIN_CHUNK = 64  # kMinChunk: fewest rows a chunk


class Plan(NamedTuple):
    """A call's geometry (the C ``tower_plan``)."""

    vec: int  # columns a lane: 16 bytes of cd where the width allows, else 1
    tiles: int  # column tiles of 32 vec columns
    chunk_rows: int
    chunks: int


def plan(rows: int, n: int, bf16: bool) -> Plan:
    """The geometry of a call on (rows, n) in bf16 or fp32, a pure function
    of the shapes that fixes every reduction's order: the C ``tower_plan``."""
    if rows < 0 or n < 1:
        raise ValueError(f"tower kernels need rows >= 0 and n >= 1; got {rows} x {n}")
    wide = 8 if bf16 else 4
    vec = wide if n % wide == 0 else 1
    tiles = _cdiv(n, 32 * vec)
    want = max(1, TARGET_BLOCKS // tiles)
    chunk_rows = max(MIN_CHUNK, _cdiv(_cdiv(rows, want), WARPS) * WARPS)
    return Plan(vec, tiles, chunk_rows, _cdiv(rows, chunk_rows) if rows else 1)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fwd_launches(bn: bool) -> int:
    """Kernel launches of a layer's forward: ``fwd_sums``, ``fwd_devs`` and
    ``fwd_apply`` with BatchNorm, ``fwd_apply`` alone without."""
    return 5 if bn else 1


def bwd_launches(bn: bool) -> int:
    """Kernel launches of a layer's backward: ``bwd_sums`` and ``bwd_dx``
    with BatchNorm, ``bwd_dx`` alone without."""
    return 4 if bn else 2


def code_bytes(n: int) -> int:
    """Bytes of a row's code: one bit a column."""
    return _cdiv(n, 8)


def pack_code(bits: torch.Tensor) -> torch.Tensor:
    """(rows, n) bool -> (rows, code_bytes(n)) uint8, bit k of byte m the
    element of column 8 m + k; the bits past n are 0."""
    rows, n = bits.shape
    pad = 8 * code_bytes(n) - n
    b = torch.nn.functional.pad(bits.to(torch.uint8), (0, pad)).reshape(rows, code_bytes(n), 8)
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.uint8, device=bits.device)
    return (b * weights).sum(-1, dtype=torch.uint8)


def unpack_code(code: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of ``pack_code``: (rows, code_bytes(n)) uint8 -> (rows, n) bool."""
    shifts = torch.arange(8, dtype=torch.uint8, device=code.device)
    bits = (code[..., None] >> shifts) & 1
    return bits.reshape(code.shape[0], 8 * code.shape[1])[:, :n].bool()


# ---------------------------------------------------------------- plain versions
#
# Each block's arithmetic in PyTorch, rounded where the kernel rounds; the
# kernels add in another order, so the two agree to rounding, not bit for bit.


def _acc(y):
    return torch.float64 if y.dtype == torch.float64 else torch.float32


def _h(y, bias):
    h = y.to(_acc(y))
    return h if bias is None else h + bias.to(h.dtype)


def _mean(sums, n):
    return sums[:n] / sums[n].clamp(min=1.0)


def _cols(sums, devs, gamma, beta, n):
    """(mean, inv, a, c) of each column."""
    cnt = sums[n].clamp(min=1.0)
    mean = sums[:n] / cnt
    inv = 1.0 / torch.sqrt(devs / cnt + EPS)
    a = gamma.to(inv.dtype) * inv
    return mean, inv, a, beta.to(inv.dtype) - mean * a


def fwd_sums_plain(y, bias, weight):
    """(n + 1,): sum over rows of w h, then S = sum w (the row count without
    weights)."""
    h = _h(y, bias)
    if weight is None:
        return torch.cat([h.sum(0), h.new_full((1,), float(h.shape[0]))])
    w = weight.to(h.dtype)
    return torch.cat([(w[:, None] * h).sum(0), w.sum().reshape(1)])


def fwd_devs_plain(y, bias, weight, sums):
    """(n,): sum over rows of w (h - mean)^2, the mean from ``sums``."""
    h = _h(y, bias)
    d = h - _mean(sums.to(h.dtype), h.shape[1])
    dd = d * d
    return (dd if weight is None else weight.to(h.dtype)[:, None] * dd).sum(0)


def fwd_apply_plain(y, bias, gamma, beta, sums, devs, u, keep, run_mean, run_var):
    """(out in y's dtype, code, running): running is the new (mean, var)
    stacked (2, n) with BatchNorm (``sums`` given), else empty."""
    h = _h(y, bias)
    n = h.shape[1]
    running = h.new_empty(0)
    if sums is not None:
        sums, devs = sums.to(h.dtype), devs.to(h.dtype)
        mean, _, a, c = _cols(sums, devs, gamma, beta, n)
        z = a * h + c
        cnt = sums[n].clamp(min=1.0)
        unbiased = devs / cnt * (cnt / (cnt - 1.0).clamp(min=1.0))
        running = torch.stack([(1 - MOMENTUM) * run_mean.to(h.dtype) + MOMENTUM * mean,
                               (1 - MOMENTUM) * run_var.to(h.dtype) + MOMENTUM * unbiased])
    else:
        z = h
    on = z > 0
    if u is not None:
        on = on & (u < keep)
    out = torch.where(on, z * (1.0 / keep), 0.0).to(y.dtype)
    return out, pack_code(on), running.to(run_mean.dtype) if sums is not None else running


def _g_xh(dout, y, code, bias, sums, devs, gamma, beta, keep):
    h = _h(y, bias)
    n = h.shape[1]
    g = torch.where(unpack_code(code, n), dout.to(h.dtype) * (1.0 / keep), 0.0)
    if sums is None:
        return h, g, None, None
    mean, inv, a, _ = _cols(sums.to(h.dtype), devs.to(h.dtype), gamma, beta, n)
    return h, g, (h - mean) * inv, a


def bwd_sums_plain(dout, y, code, bias, gamma, beta, sums, devs, keep):
    """(2n,): sum over rows of g, then of g xh."""
    _, g, xh, _ = _g_xh(dout, y, code, bias, sums, devs, gamma, beta, keep)
    return torch.cat([g.sum(0), (g * xh).sum(0)])


def bwd_dx_plain(dout, y, code, bias, gamma, beta, sums, devs, gsums, weight, keep):
    """(dh in y's dtype, db): with BatchNorm dh = a (g - w (dbeta + xh
    dgamma) / N), ``gsums`` the global (dbeta, dgamma); without, dh = g."""
    h, g, xh, a = _g_xh(dout, y, code, bias, sums, devs, gamma, beta, keep)
    if sums is None:
        dh = g
    else:
        n = h.shape[1]
        gsums = gsums.to(h.dtype)
        t = gsums[:n] + xh * gsums[n:]
        if weight is not None:
            t = weight.to(h.dtype)[:, None] * t
        dh = a * (g - t * (1.0 / sums[n].to(h.dtype).clamp(min=1.0)))
    return dh.to(y.dtype), dh.sum(0)


# ---------------------------------------------------------------- the kernels

_LIB = None


def _kernel_lib():
    global _LIB
    if _LIB is None:
        lib = build.load("tower")
        vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.tower_plan.argtypes = [ll, ll, i, ctypes.POINTER(ll)]
        lib.tower_plan.restype = i
        lib.tower_fwd_sums.argtypes = [vp] * 5 + [ll, i, i, vp]
        lib.tower_fwd_devs.argtypes = [vp] * 6 + [ll, i, i, vp]
        lib.tower_fwd_apply.argtypes = [vp] * 7 + [f, f] + [vp] * 6 + [ll, i, i, vp]
        lib.tower_bwd_sums.argtypes = [vp] * 8 + [f] + [vp] * 2 + [ll, i, i, vp]
        lib.tower_bwd_dx.argtypes = [vp] * 10 + [f] + [vp] * 3 + [ll, i, i, vp]
        for fn in (lib.tower_fwd_sums, lib.tower_fwd_devs, lib.tower_fwd_apply,
                   lib.tower_bwd_sums, lib.tower_bwd_dx):
            fn.restype = i
        _LIB = lib
    return _LIB


def c_plan(rows: int, n: int, bf16: bool) -> Plan | None:
    """The C ``tower_plan`` (the card's library), None for no columns."""
    out = (ctypes.c_longlong * 4)()
    if _kernel_lib().tower_plan(rows, n, int(bf16), out):
        return None
    return Plan(*out)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _operand(t, dtype):
    """t as a contiguous, 16-byte aligned tensor of ``dtype`` (None stays None)."""
    if t is None:
        return None
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _on_card(what: str, y, **operands) -> tuple[int, int, int]:
    """(rows, n, bf16) of a kernel call on y (rows, n), which must be bf16 or
    fp32 on a card; raises unless each of ``operands`` (None or a tensor,
    by its name in the C call) has its shape and lies on y's device."""
    if y.dtype not in (torch.bfloat16, torch.float32) or y.dim() != 2:
        raise ValueError(f"{what}: y must be (rows, n) bfloat16 or float32, got "
                         f"{tuple(y.shape)} {y.dtype}")
    rows, n = y.shape
    shapes = {"bias": (n,), "gamma": (n,), "beta": (n,), "run_mean": (n,), "run_var": (n,),
              "sums": (n + 1,), "devs": (n,), "gsums": (2 * n,), "weight": (rows,),
              "u": (rows, n), "dout": (rows, n), "code": (rows, code_bytes(n))}
    for name, t in operands.items():
        if t is not None and (tuple(t.shape) != shapes[name] or t.device != y.device):
            raise ValueError(f"{what}: {name} is {tuple(t.shape)} on {t.device}, expected "
                             f"{shapes[name]} on {y.device}")
    return rows, n, int(y.dtype == torch.bfloat16)


def _part(y, rows, n, bf16, width):
    return torch.empty(plan(rows, n, bf16).chunks * width, dtype=torch.float32, device=y.device)


def fwd_sums(y, bias, weight):
    """``fwd_sums_plain``: on a card 2 launches, fp32 out."""
    if y.device.type == "cpu":
        return fwd_sums_plain(y, bias, weight)
    rows, n, bf16 = _on_card("fwd_sums", y, bias=bias, weight=weight)
    f32 = torch.float32
    y, bias, weight = _operand(y, y.dtype), _operand(bias, f32), _operand(weight, f32)
    sums = torch.empty(n + 1, dtype=f32, device=y.device)
    rc = _kernel_lib().tower_fwd_sums(y.data_ptr(), _ptr(bias), _ptr(weight),
                                      _part(y, rows, n, bf16, n + 1).data_ptr(), sums.data_ptr(),
                                      rows, n, bf16, stream_of(y))
    build.check(rc, "tower_fwd_sums")
    fwd_sums.launches += 2
    return sums


def fwd_devs(y, bias, weight, sums):
    """``fwd_devs_plain``: on a card 2 launches, fp32 out."""
    if y.device.type == "cpu":
        return fwd_devs_plain(y, bias, weight, sums)
    rows, n, bf16 = _on_card("fwd_devs", y, bias=bias, weight=weight, sums=sums)
    f32 = torch.float32
    y, bias, weight, sums = (_operand(y, y.dtype), _operand(bias, f32), _operand(weight, f32),
                             _operand(sums, f32))
    devs = torch.empty(n, dtype=f32, device=y.device)
    rc = _kernel_lib().tower_fwd_devs(y.data_ptr(), _ptr(bias), _ptr(weight), sums.data_ptr(),
                                      _part(y, rows, n, bf16, n).data_ptr(), devs.data_ptr(),
                                      rows, n, bf16, stream_of(y))
    build.check(rc, "tower_fwd_devs")
    fwd_devs.launches += 2
    return devs


def fwd_apply(y, bias, gamma, beta, sums, devs, u, keep, run_mean, run_var):
    """``fwd_apply_plain``: on a card 1 launch."""
    if y.device.type == "cpu":
        return fwd_apply_plain(y, bias, gamma, beta, sums, devs, u, keep, run_mean, run_var)
    rows, n, bf16 = _on_card("fwd_apply", y, bias=bias, gamma=gamma, beta=beta, sums=sums,
                              devs=devs, u=u, run_mean=run_mean, run_var=run_var)
    f32 = torch.float32
    bn = sums is not None
    y, bias, u = _operand(y, y.dtype), _operand(bias, f32), _operand(u, f32)
    gamma, beta, sums, devs, run_mean, run_var = (
        _operand(t, f32) if bn else None for t in (gamma, beta, sums, devs, run_mean, run_var))
    out = torch.empty_like(y)
    code = torch.empty(rows, code_bytes(n), dtype=torch.uint8, device=y.device)
    running = torch.empty((2, n) if bn else (0,), dtype=f32, device=y.device)
    rc = _kernel_lib().tower_fwd_apply(
        y.data_ptr(), _ptr(bias), _ptr(gamma), _ptr(beta), _ptr(sums), _ptr(devs), _ptr(u),
        keep, 1.0 / keep, _ptr(run_mean), _ptr(run_var), _ptr(running[0]) if bn else None,
        _ptr(running[1]) if bn else None, out.data_ptr(), code.data_ptr(), rows, n, bf16,
        stream_of(y))
    build.check(rc, "tower_fwd_apply")
    fwd_apply.launches += 1
    return out, code, running


def bwd_sums(dout, y, code, bias, gamma, beta, sums, devs, keep):
    """``bwd_sums_plain``: on a card 2 launches, fp32 out."""
    if y.device.type == "cpu":
        return bwd_sums_plain(dout, y, code, bias, gamma, beta, sums, devs, keep)
    rows, n, bf16 = _on_card("bwd_sums", y, dout=dout, code=code, bias=bias, gamma=gamma,
                              beta=beta, sums=sums, devs=devs)
    f32 = torch.float32
    dout, y, code = _operand(dout, y.dtype), _operand(y, y.dtype), _operand(code, torch.uint8)
    bias, gamma, beta, sums, devs = (_operand(t, f32) for t in (bias, gamma, beta, sums, devs))
    gsums = torch.empty(2 * n, dtype=f32, device=y.device)
    rc = _kernel_lib().tower_bwd_sums(
        dout.data_ptr(), y.data_ptr(), code.data_ptr(), _ptr(bias), gamma.data_ptr(),
        beta.data_ptr(), sums.data_ptr(), devs.data_ptr(), 1.0 / keep,
        _part(y, rows, n, bf16, 2 * n).data_ptr(), gsums.data_ptr(), rows, n, bf16, stream_of(y))
    build.check(rc, "tower_bwd_sums")
    bwd_sums.launches += 2
    return gsums


def bwd_dx(dout, y, code, bias, gamma, beta, sums, devs, gsums, weight, keep):
    """``bwd_dx_plain``: on a card 2 launches; dh in y's dtype, db fp32."""
    if y.device.type == "cpu":
        return bwd_dx_plain(dout, y, code, bias, gamma, beta, sums, devs, gsums, weight, keep)
    rows, n, bf16 = _on_card("bwd_dx", y, dout=dout, code=code, bias=bias, gamma=gamma,
                              beta=beta, sums=sums, devs=devs, gsums=gsums, weight=weight)
    f32 = torch.float32
    bn = sums is not None
    dout, y, code = _operand(dout, y.dtype), _operand(y, y.dtype), _operand(code, torch.uint8)
    bias, weight = _operand(bias, f32), _operand(weight, f32)
    gamma, beta, sums, devs, gsums = (
        _operand(t, f32) if bn else None for t in (gamma, beta, sums, devs, gsums))
    dh = torch.empty_like(y)
    db = torch.empty(n, dtype=f32, device=y.device)
    rc = _kernel_lib().tower_bwd_dx(
        dout.data_ptr(), y.data_ptr(), code.data_ptr(), _ptr(bias), _ptr(gamma), _ptr(beta),
        _ptr(sums), _ptr(devs), _ptr(gsums), _ptr(weight), 1.0 / keep, dh.data_ptr(),
        _part(y, rows, n, bf16, n).data_ptr(), db.data_ptr(), rows, n, bf16, stream_of(y))
    build.check(rc, "tower_bwd_dx")
    bwd_dx.launches += 2
    return dh, db


BLOCKS = (fwd_sums, fwd_devs, fwd_apply, bwd_sums, bwd_dx)
for _fn in BLOCKS:
    _fn.launches = 0


def launches() -> int:
    """The kernel launches the five blocks have counted."""
    return sum(fn.launches for fn in BLOCKS)


class TowerLayer(torch.autograd.Function):
    """One layer after its GEMM, both ways on the blocks: (y, bias, gamma,
    beta) -> (out, running). ``gamma`` None: no BatchNorm (``beta``,
    ``run_mean``, ``run_var`` None too, ``running`` empty). ``u``: the
    uniforms, None at rate 0; ``weight``: (rows,) or None; ``group``: the
    data-parallel group, whose ranks' sums are all-reduced between the
    blocks, or None."""

    @staticmethod
    def forward(ctx, y, bias, gamma, beta, u, weight, run_mean, run_var, keep, group):
        sums = devs = None
        if gamma is not None:
            sums = fwd_sums(y, bias, weight)
            if group is not None:
                data_parallel.all_reduce_(sums, group)
            devs = fwd_devs(y, bias, weight, sums)
            if group is not None:
                data_parallel.all_reduce_(devs, group)
        out, code, running = fwd_apply(y, bias, gamma, beta, sums, devs, u, keep, run_mean,
                                       run_var)
        ctx.save_for_backward(y, code, bias, gamma, beta, sums, devs, weight)
        ctx.keep, ctx.group = keep, group
        ctx.mark_non_differentiable(running)
        ctx.set_materialize_grads(False)  # no zeros launched for running's cotangent
        return out, running

    @staticmethod
    def backward(ctx, dout, _):
        if dout is None:  # out reached no loss
            return (None,) * 10
        y, code, bias, gamma, beta, sums, devs, weight = ctx.saved_tensors
        dgamma = dbeta = gsums = None
        if gamma is not None:
            local = bwd_sums(dout, y, code, bias, gamma, beta, sums, devs, ctx.keep)
            gsums = local
            if ctx.group is not None:
                gsums = data_parallel.all_reduce_(local.clone(), ctx.group)
            n = y.shape[1]
            dbeta, dgamma = local[:n].to(beta.dtype), local[n:].to(gamma.dtype)
        dh, db = bwd_dx(dout, y, code, bias, gamma, beta, sums, devs, gsums, weight, ctx.keep)
        return (dh, None if bias is None else db.to(bias.dtype), dgamma, dbeta, None, None, None,
                None, None, None)
