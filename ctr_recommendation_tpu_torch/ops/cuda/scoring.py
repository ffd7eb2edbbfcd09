"""Kernel 2: fused batched scoring, interaction + folded tower (csrc/scoring.cu).

Replaces ctr_recommendation_tpu/ops/pallas/scoring.py::_kernel (:36),
reached through ``fused_score`` (:196), with its "all" and "each" bodies.

Bound on an H100: operations. At B=8192 the BatchNorm-folded tower
2688 -> 512 -> 256 -> 1 is 26 GFLOP (26.3 us at 989 TFLOP/s bf16) against
~15 MB of input, output and weights. The TPU kernel holds the (TB, 21E)
concat and all of W1 in VMEM; an H100 block has 227 KB of shared memory, so
one call here is a sequence of four building blocks, each with its own
wrapper and plain version, in ``score_launches()`` launches:

1. ``score_front``: the interaction forward's three launches of
   csrc/interaction.cuh (``interaction.fwd_launches()``: the gate, V =
   cd(sc W) on the tile product, the pairs) writing the concat c = [S |
   pairs] (B, 21E) in the tower dtype cd, bit for bit the interaction
   forward's output;
2. ``tower_layer``: h1 = cd(relu(c W1 + b1)), the tile product of
   csrc/tile_mma.cuh (bf16: ``ldmatrix`` / ``mma.sync`` on the tensor
   cores, 128 x 128 tiles, fp32 accumulators; fp32: CUDA-core FMA with fp64
   accumulators) with a fused bias + ReLU + rounding epilogue;
3. ``tower_layer`` again: h2 = cd(relu(h1 W2 + b2));
4. ``score_head``: sigmoid(h2 w3 + b3), one warp a row.

``score_fwd`` enqueues the four in one C call and allocates c, h1, h2 and
the front's workspace (the kernels allocate nothing). Envelope
(``ENVELOPE``, ``fits``, ``check_envelope``): F >= 2, E % 8 == 0, any two-layer tower
with H1 % 8 == 0 and H2 % 8 == 0 (read from the weights, as the TPU kernel
reads them), any B; that holds the recorded towers (512, 256), (1024, 512)
and (768, 384) at E=128 and 256 in bf16 and fp32. ``prepare_score_params``
brings any other E, H1 and H2 into it: it zero-pads E as the interaction's
entry point does (``pad_senet_bilinear``, W1's rows laid out again for the
wider concat) and each tower width to a multiple of 8 with zero weights and
biases, whose units read relu(0) = 0 and feed nothing on; ``score_fwd``
zero-pads x to the weights' E.
Left for later: ``wgmma`` with TMA-staged tiles, and the front fused into
layer 1's operand staging so that c never reaches device memory.

Each wrapper, on a CUDA tensor, launches its kernel (or raises); on a CPU
tensor it runs its plain PyTorch version with the same rounding points.
``score_fwd_plain`` is the composition of the blocks' plain versions. The
wrappers' ``launches`` attributes count kernel launches: ``score_fwd``'s
``score_launches()`` a call, the front's ``fwd_launches()``, each other
block's one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ctr_recommendation_tpu_torch.ops.cuda import build
from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
    check_kernel_args,
    cuda_only,
    fwd_gate_plain,
    fwd_launches,
    fwd_pairs_plain,
    fwd_project_plain,
    is_bf16,
    pad_senet_bilinear,
    padded_width,
    senet_weights,
    stream_of,
)
from ctr_recommendation_tpu_torch.ops.cuda.interaction import fits as inter_fits
from ctr_recommendation_tpu_torch.utils.profiling import span

ENVELOPE = "F >= 2, E % 8 == 0 and a 2-layer tower with H1 % 8 == 0 and H2 % 8 == 0 (any B)"


def score_launches() -> int:
    """Kernel launches of one ``score_fwd`` call: the front's
    ``fwd_launches()``, the two tower layers and the head."""
    return fwd_launches() + 3


def fits(f: int, e: int, h1: int, h2: int) -> bool:
    """Whether the kernels take F fields of width E and the two-layer tower
    (H1, H2) (``ENVELOPE``): a pure function of the shapes."""
    return inter_fits(f, e) and h1 >= 8 and h1 % 8 == 0 and h2 >= 8 and h2 % 8 == 0


def check_envelope(f: int, e: int, h1: int, h2: int) -> None:
    """Raise unless the kernels take F fields of width E and the tower
    (H1, H2) (``fits``)."""
    if not fits(f, e, h1, h2):
        raise ValueError(f"fused_score needs {ENVELOPE}; got F={f}, E={e}, tower {(h1, h2)}")


# ---------------------------------------------------------------- plain versions


def score_front_plain(x, sw1, sb1, sw2, sb2, w_bi, *, bilinear_type="all"):
    """x (B, F, E) in cd -> the concat [S | pairs] (B, (F + F(F-1)/2) E) in
    cd: the interaction forward's three plain blocks, the output in cd."""
    kw = dict(bilinear_type=bilinear_type)
    w, sc = fwd_gate_plain(x, sw1, sb1, sw2, sb2, **kw)
    return fwd_pairs_plain(x, w, fwd_project_plain(sc, w_bi, **kw), **kw, out_dtype=x.dtype)


def tower_layer_plain(a, w, bias):
    """cd(relu(a w + bias)): a (M, K), w (K, N) in cd, bias (N,) fp32; the
    product accumulated in fp32."""
    return torch.relu(a.float() @ w.float() + bias.float()).to(a.dtype)


def score_head_plain(h2, w3, b3):
    """sigmoid(h2 w3 + b3) -> (B,) fp32: h2 (B, H2), w3 (H2, 1) in cd, b3 (1,)."""
    return torch.sigmoid(h2.float() @ w3.float() + b3.float())[:, 0]


def score_fwd_plain(
    x, sw1, sb1, sw2, sb2, w_bi, w1, b1, w2, b2, w3, b3, *, bilinear_type="all"
):
    """Plain PyTorch version: x (B, F, E) in the tower dtype cd -> (B,) fp32.
    The concat is cd; every product accumulates in fp32; h1 and h2 are cast
    to cd before the next product; biases and the sigmoid are fp32."""
    c = score_front_plain(x, sw1, sb1, sw2, sb2, w_bi, bilinear_type=bilinear_type)
    return score_head_plain(tower_layer_plain(tower_layer_plain(c, w1, b1), w2, b2), w3, b3)


# ---------------------------------------------------------------- the kernels

_LIB = None


def _kernel_lib():
    global _LIB
    if _LIB is None:
        lib = build.load("scoring")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.score_front_workspace.argtypes = [i] * 4
        lib.score_front_workspace.restype = ctypes.c_size_t
        lib.score_front.argtypes = [vp] * 8 + [i] * 6 + [vp]
        lib.score_layer.argtypes = [vp] * 4 + [i] * 4 + [vp]
        lib.score_head.argtypes = [vp] * 4 + [i] * 3 + [vp]
        lib.fused_score.argtypes = [vp] * 17 + [i] * 8 + [vp]
        for fn in (lib.score_front, lib.score_layer, lib.score_head, lib.fused_score):
            fn.restype = i
        _LIB = lib
    return _LIB


def _front_args(x, sw1, sb1, sw2, sb2, w_bi, bilinear_type):
    """Shapes and dtypes of the front's operands (CUDA); returns (B, F, E,
    R)."""
    if bilinear_type not in ("all", "each"):
        raise ValueError(f"bilinear_type must be 'all' or 'each', got {bilinear_type!r}")
    b, f, e = x.shape
    if not inter_fits(f, e):
        raise ValueError(f"fused_score needs {ENVELOPE}; got F={f}, E={e}")
    r = sw1.shape[1]
    wbi_shape = (e, e) if bilinear_type == "all" else (f - 1, e, e)
    shapes = {"sw1": (sw1, (f, r)), "sb1": (sb1, (r,)), "sw2": (sw2, (r, f)),
              "sb2": (sb2, (f,)), "w_bi": (w_bi, wbi_shape)}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
    f32 = torch.float32
    check_kernel_args(
        {"x": (x, None), "sw1": (sw1, f32), "sb1": (sb1, f32), "sw2": (sw2, f32),
         "sb2": (sb2, f32), "w_bi": (w_bi, None)},
        x.dtype, x.device,
    )
    return b, f, e, r


@functools.lru_cache(maxsize=64)
def _front_workspace(b: int, f: int, e: int, bf16: int) -> int:
    """Bytes of the front's workspace (w, sc and V) at these sizes."""
    return _kernel_lib().score_front_workspace(b, f, e, bf16)


def score_front(x, sw1, sb1, sw2, sb2, w_bi, *, bilinear_type="all"):
    """Block 1: x (B, F, E) in cd (bf16/fp32), SENet weights fp32, w_bi in
    cd -> the concat c (B, (F + F(F-1)/2) E) in cd; ``fwd_launches()``
    launches."""
    if x.device.type == "cpu":
        return score_front_plain(x, sw1, sb1, sw2, sb2, w_bi, bilinear_type=bilinear_type)
    cuda_only("score_front", x)
    b, f, e, r = _front_args(x, sw1, sb1, sw2, sb2, w_bi, bilinear_type)
    c = torch.empty(b, (f + f * (f - 1) // 2) * e, dtype=x.dtype, device=x.device)
    if b == 0:
        return c
    ws = torch.empty(_front_workspace(b, f, e, is_bf16(x)), dtype=torch.uint8, device=x.device)
    rc = _kernel_lib().score_front(
        *(t.data_ptr() for t in (x, sw1, sb1, sw2, sb2, w_bi, c, ws)),
        b, f, e, r, is_bf16(x), int(bilinear_type == "each"), stream_of(x))
    build.check(rc, "score_front")
    score_front.launches += fwd_launches()
    return c


def tower_layer(a, w, bias):
    """Blocks 2-3: cd(relu(a w + bias)), a (M, K) and w (K, N) in cd (bf16 /
    fp32), bias (N,) fp32; N and K multiples of 8."""
    if a.device.type == "cpu":
        return tower_layer_plain(a, w, bias)
    cuda_only("tower_layer", a)
    m, k = a.shape
    n = w.shape[1]
    if tuple(w.shape) != (k, n) or tuple(bias.shape) != (n,):
        raise ValueError(f"tower_layer: a {tuple(a.shape)}, w {tuple(w.shape)}, bias "
                         f"{tuple(bias.shape)} do not chain")
    if n % 8 or k % 8:
        raise ValueError(f"tower_layer needs N % 8 == 0 and K % 8 == 0; got N={n}, K={k}")
    check_kernel_args({"a": (a, None), "w": (w, None), "bias": (bias, torch.float32)},
                      a.dtype, a.device)
    out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    if m == 0:
        return out
    rc = _kernel_lib().score_layer(a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                   m, n, k, is_bf16(a), stream_of(a))
    build.check(rc, "tower_layer")
    tower_layer.launches += 1
    return out


def score_head(h2, w3, b3):
    """Block 4: sigmoid(h2 w3 + b3) -> (B,) fp32; h2 (B, H2), w3 (H2, 1) in
    cd (bf16 / fp32), b3 (1,) fp32; H2 % 8 == 0."""
    if h2.device.type == "cpu":
        return score_head_plain(h2, w3, b3)
    cuda_only("score_head", h2)
    b, h = h2.shape
    if tuple(w3.shape) != (h, 1) or tuple(b3.shape) != (1,):
        raise ValueError(f"score_head: w3 {tuple(w3.shape)}, b3 {tuple(b3.shape)} for H2={h}")
    if h % 8:
        raise ValueError(f"score_head needs H2 % 8 == 0; got H2={h}")
    check_kernel_args({"h2": (h2, None), "w3": (w3, None), "b3": (b3, torch.float32)},
                      h2.dtype, h2.device)
    out = torch.empty(b, dtype=torch.float32, device=h2.device)
    if b == 0:
        return out
    rc = _kernel_lib().score_head(h2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
                                  b, h, is_bf16(h2), stream_of(h2))
    build.check(rc, "score_head")
    score_head.launches += 1
    return out


def score_fwd(
    x, sw1, sb1, sw2, sb2, w_bi, w1, b1, w2, b2, w3, b3, *, bilinear_type="all"
):
    """x (B, F, E) in the tower dtype (bf16/fp32); SENet weights fp32; w_bi,
    w1 (C, H1), w2 (H1, H2), w3 (H2, 1) in x's dtype; b1, b2, b3 fp32 ->
    click probabilities (B,) fp32. On a card: the four blocks, enqueued by
    one C call (``score_launches()`` launches). An x narrower than w_bi
    (weights padded by ``prepare_score_params``) is zero-padded to it. The
    span ``score_fwd`` while a profiler runs."""
    with span("score_fwd"):
        return _score_fwd(x, sw1, sb1, sw2, sb2, w_bi, w1, b1, w2, b2, w3, b3,
                          bilinear_type=bilinear_type)


def _score_fwd(x, sw1, sb1, sw2, sb2, w_bi, w1, b1, w2, b2, w3, b3, *, bilinear_type):
    if x.shape[-1] < w_bi.shape[-1]:
        x = torch.nn.functional.pad(x, (0, w_bi.shape[-1] - x.shape[-1]))
    args = (x, sw1, sb1, sw2, sb2, w_bi, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return score_fwd_plain(*args, bilinear_type=bilinear_type)
    cuda_only("score_fwd", x)
    h1, h2 = w1.shape[1], w2.shape[1]
    check_envelope(x.shape[1], x.shape[2], h1, h2)
    b, f, e, r = _front_args(x, sw1, sb1, sw2, sb2, w_bi, bilinear_type)
    cdim = (f + f * (f - 1) // 2) * e
    shapes = {"w1": (w1, (cdim, h1)), "b1": (b1, (h1,)), "w2": (w2, (h1, h2)),
              "b2": (b2, (h2,)), "w3": (w3, (h2, 1)), "b3": (b3, (1,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
    f32 = torch.float32
    check_kernel_args(
        {"w1": (w1, None), "b1": (b1, f32), "w2": (w2, None), "b2": (b2, f32),
         "w3": (w3, None), "b3": (b3, f32)},
        x.dtype, x.device,
    )
    out = torch.empty(b, dtype=f32, device=x.device)
    if b == 0:
        return out
    c = torch.empty(b, cdim, dtype=x.dtype, device=x.device)
    s1 = torch.empty(b, h1, dtype=x.dtype, device=x.device)
    s2 = torch.empty(b, h2, dtype=x.dtype, device=x.device)
    ws = torch.empty(_front_workspace(b, f, e, is_bf16(x)), dtype=torch.uint8, device=x.device)
    rc = _kernel_lib().fused_score(
        *(t.data_ptr() for t in (*args, c, s1, s2, ws, out)),
        b, f, e, r, h1, h2, is_bf16(x), int(bilinear_type == "each"),
        stream_of(x),
    )
    build.check(rc, "fused_score")
    score_fwd.launches += score_launches()
    return out


score_fwd.launches = 0
score_front.launches = 0
tower_layer.launches = 0
score_head.launches = 0


def prepare_score_params(
    senet_params: dict, bilinear_params: dict, folded_mlp: dict, *,
    bilinear_type: str, compute_dtype: torch.dtype,
) -> tuple:
    """The kernel's weight operands, cast once: SENet and biases fp32, the
    bilinear and tower weights in ``compute_dtype``. ``folded_mlp`` comes
    from ops.mlp.fold_batch_norm and must have exactly 2 hidden layers.
    E, H1 and H2 come out zero-padded to multiples of 8 (``padded_width``),
    the same function on the kernels' widths."""
    if len(folded_mlp["layers"]) != 2:
        raise ValueError("fused_score expects a 2-hidden-layer tower")
    device = senet_params["fc1"]["w"].device
    f = senet_params["fc2"]["w"].shape[1]
    w_bi = bilinear_params["w"] if bilinear_type == "all" else bilinear_params["w_each"]
    l1 = folded_mlp["layers"][0]["linear"]
    l2 = folded_mlp["layers"][1]["linear"]
    l3 = folded_mlp["out"]
    pad = torch.nn.functional.pad

    def bias(lin):
        if "b" in lin:
            return lin["b"].float()
        return torch.zeros(lin["w"].shape[1], device=device)

    sw1, sb1, sw2, sb2 = senet_weights(senet_params, f)
    w1, w2, w3 = l1["w"], l2["w"], l3["w"]
    e, (h1, h2) = w_bi.shape[-1], (w1.shape[1], w2.shape[1])
    ep, h1p, h2p = padded_width(e), padded_width(h1), padded_width(h2)
    if ep != e:  # W1's rows follow the concat [S | pairs], E columns a field or pair
        sw1, w_bi = pad_senet_bilinear(sw1, w_bi, e, ep)
        n = w1.shape[0] // e
        w1 = pad(w1.reshape(n, e, h1), (0, 0, 0, ep - e)).reshape(n * ep, h1)
    w1, w2, w3 = pad(w1, (0, h1p - h1)), pad(w2, (0, h2p - h2, 0, h1p - h1)), pad(
        w3, (0, 0, 0, h2p - h2))
    b1, b2 = pad(bias(l1), (0, h1p - h1)), pad(bias(l2), (0, h2p - h2))

    def wt(t):
        return t.to(compute_dtype).contiguous()

    return (
        sw1.contiguous(), sb1, sw2, sb2, wt(w_bi),
        wt(w1), b1.contiguous(), wt(w2), b2.contiguous(), wt(w3), bias(l3).contiguous(),
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
