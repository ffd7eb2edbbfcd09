"""The fused SENet + bilinear + concat block on hand-written kernels.

Forward (csrc/interaction.cu) replaces ctr_recommendation_tpu/ops/pallas/
interaction.py::_kernel_all (:56) and ::_kernel_each (:94); backward
(csrc/interaction_bwd.cu) replaces ::_bwd_kernel (:250). Both are reached
through ``fused_senet_bilinear_concat`` (:566), whose ``jax.custom_vjp``
becomes the ``FusedInteraction`` autograd Function here.

Bound on an H100: bytes, both ways. At B=8192, F=6, E=128 with bf16 input
the forward must read 12.6 MB and write 88 MB of fp32 output (30 us at
3.35 TB/s); at B=4096 the backward must read g (44 MB fp32) and x and write
dx, 56.6 MB in all (17 us; 34 us at E=256), against 2.0 GFLOP of E x E
products (8.1 at E=256) far below the tensor cores' line.

Forward: three launches (``fwd_launches()``), each a building block with
its own wrapper and plain version here, enqueued by one C call (the
scoring call's front, csrc/scoring.cu, runs the same three with the output
in the compute dtype cd):

1. ``fwd_gate``: w (fp32) and sc = cd(x_p cd(w_p)), one warp a row (the
   forward's rounding points; the backward's gate is the same kernel at
   its own);
2. ``fwd_project``: V = cd(sc W), the tile product of csrc/tile_mma.cuh
   (bf16 ``mma.sync`` on the tensor cores; fp32 on the CUDA cores with
   fp64 accumulators, never TF32), stored in cd;
3. ``fwd_pairs``: S = cd(x cd(w)) recomputed, and each output row written
   once with 16-byte stores: the S columns, then the pairs cd(S_i V_j)
   ("all") or cd(V_i S_j) ("each") in triu order.

~155 MB of traffic a call at B=8192, E=128. ``interaction_fwd_plain`` stays
the single expression it was; a CPU test holds the blocks' plain versions,
composed, bit for bit equal to it.

Backward: seven launches (``bwd_launches()``), each a building block with
its own wrapper and plain version here, enqueued by one C call:

1. ``bwd_gate``: z, h1, w (fp32) and sc = cd(x_p w_p), one warp a row;
2. ``bwd_project``: V = sc W (fp32, not rounded), the tile product;
3. ``bwd_pairs``: the pairs' backward, streaming g once as 16-byte loads:
   ds (B, F, E) fp32 and dvc = cd(dv_p);
4. ``bwd_project_t``: the projection term P = dvc W^T (fp32), the tile
   product reading W as stored;
5. ``bwd_gate_dx``: the gate's backward on ds + P, dx = cd(ds w + dz / E),
   and per-block partials of dW1, db1, dW2, db2 over fixed row chunks;
6. ``bwd_weight_grad``: dW_bi = sc^T dvc, the tile product over rows split
   into chunks (``weight_grad_split``), one fp32 partial each;
7. ``bwd_reduce``: each weight gradient the sum of its partials in a fixed
   order, so repeats are bit-identical (no atomics).

``interaction_bwd_plain`` is the composition of the seven blocks' plain
versions; ``interaction_bwd_expr`` the single expression it replaced, the
yardstick whose time chip_smoke.py reports beside it.

The projected fields p are 1..F-1 for "all" and 0..F-2 for "each"; sc, V
(then P), dvc are field-major (F-1, B, E), so every operand of a product is
a plain contiguous matrix and "each" runs its F-1 products as groups of one
launch. Each call's wrapper allocates its scratch in one workspace (~185 MB
of traffic a backward call at B=4096, E=128); the kernels allocate nothing.
Envelope, both ways: F >= 2, E % 8 == 0, any B (``ENVELOPE``,
``check_fwd_envelope``, ``check_bwd_envelope``); the pairs passes and the
gate backward hold a row's fields in registers for F <= 8 and recompute or
sum in their outputs beyond.

``fused_senet_bilinear_concat``, the entry point, takes any E: it zero-pads
E to ``padded_width(E)`` (a multiple of 8) before the kernels and drops the
padded columns after. Zero columns add nothing to any product, the gate or
the pairs, and the squeeze, a mean over E, is kept by scaling the SENet's
W1 by Ep / E (autograd carries the factor into dW1); so the padded call
computes the same function, up to the fp32 rounding of that product.

Outside an envelope the wrappers raise ``ValueError`` naming it. On a CUDA
tensor each wrapper launches its kernels (or raises), on a CPU tensor it
runs its plain PyTorch version with the same rounding points. The
wrappers' ``launches`` attributes count kernel launches (``fwd_launches()``
and ``bwd_launches()`` a whole call, one a block).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ctr_recommendation_tpu_torch.ops.bilinear import pair_indices
from ctr_recommendation_tpu_torch.ops.cuda import build
from ctr_recommendation_tpu_torch.utils.profiling import span


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


ENVELOPE = "F >= 2 and E % 8 == 0 (any B)"


def fits(f: int, e: int) -> bool:
    """Whether the forward and backward kernels take F fields of width E
    (``ENVELOPE``): a pure function of the shapes."""
    return f >= 2 and e >= 8 and e % 8 == 0


def padded_width(e: int) -> int:
    """E (or a tower width) rounded up to the kernels' multiple of 8."""
    return max(8, -(-e // 8) * 8)


def pad_senet_bilinear(w1, w_bi, e: int, ep: int):
    """The block's weights for x zero-padded from E to ``ep`` columns: W_bi
    zero-padded, the SENet's W1 scaled by ep / E so that the kernels'
    squeeze (a mean over ep) sees the mean over E."""
    return w1 * (ep / e), torch.nn.functional.pad(w_bi, (0, ep - e, 0, ep - e))


def stream_of(t) -> int:
    """The handle of t's device's current stream (PyTorch's raw getter: a
    tenth of a microsecond, against several for a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


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


def _projected(f: int, bilinear_type: str) -> slice:
    if bilinear_type == "all":
        return slice(1, f)
    if bilinear_type == "each":
        return slice(0, f - 1)
    raise ValueError(f"bilinear_type must be 'all' or 'each', got {bilinear_type!r}")


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


# ---------------------------------------------------------------- the forward
#
# Three building blocks (csrc/interaction.cuh), each a kernel with its plain
# version here; their composition is interaction_fwd_plain bit for bit.


def fwd_launches() -> int:
    """Kernel launches of one ``interaction_fwd`` call, either bilinear type
    ("each" runs its per-field products as groups of one launch): the gate,
    V = cd(sc W) and the pairs."""
    return 3


def check_fwd_envelope(f: int, e: int) -> None:
    """Raise unless the forward kernels take F fields of width E (``fits``)."""
    if not fits(f, e):
        raise ValueError(f"interaction_fwd needs {ENVELOPE}; got F={f}, E={e}")


def fwd_gate_plain(x, w1, b1, w2, b2, *, bilinear_type="all"):
    """Block 1: x (B, F, E) in cd -> w (B, F) fp32 and sc = x_p cd(w_p)
    (Q, B, E) in cd, the gate fp32 and rounded to cd before the product."""
    z = x.float().mean(-1)
    a = torch.relu(z @ w1.float() + b1.float())
    w = torch.sigmoid(a @ w2.float() + b2.float())
    p = _projected(x.shape[1], bilinear_type)
    sc = x[:, p] * w[:, p].to(x.dtype)[..., None]
    return w, sc.transpose(0, 1).contiguous()


def fwd_project_plain(sc, w_bi, *, bilinear_type="all", forward_rounding=True):
    """Block 2: V = cd(sc W) (Q, B, E) in cd, accumulated in fp32.
    ``forward_rounding=False``: V left in fp32, not rounded, a wrong forward
    that the bf16 norm bar of the checks must reject."""
    wf = w_bi.float()
    if bilinear_type == "all":
        v = sc.float() @ wf
    else:
        v = torch.bmm(sc.float(), wf)
    return v.to(sc.dtype) if forward_rounding else v


def fwd_pairs_plain(x, w, v, *, bilinear_type="all", out_dtype=torch.float32):
    """Block 3: x (B, F, E) in cd, w (B, F) fp32, V (Q, B, E) -> [S | the
    pairs] (B, (F + F(F-1)/2) E) in ``out_dtype`` (fp32, or cd for the
    scoring front): S = x cd(w) in cd, pairs S_i V_j ("all") or V_i S_j
    ("each") in triu order, each rounded to V's dtype."""
    b, f, _ = x.shape
    _projected(f, bilinear_type)
    s = x * w.to(x.dtype)[..., None]
    vb = v.transpose(0, 1)
    i_idx, j_idx = pair_indices(f)
    if bilinear_type == "all":  # V_j at q = j - 1
        p = s[:, i_idx] * vb[:, j_idx - 1]
    else:
        p = vb[:, i_idx] * s[:, j_idx]
    return torch.cat([s.reshape(b, -1).to(p.dtype), p.reshape(b, -1)], dim=-1).to(out_dtype)


_FWD = None


def _fwd_fns():
    global _FWD
    if _FWD is None:
        lib = build.load("interaction")
        vp, i = ctypes.c_void_p, ctypes.c_int
        sig = {
            "ifwd_gate": [vp] * 7 + [i] * 6 + [vp],
            "ifwd_project": [vp] * 3 + [i] * 5 + [vp],
            "ifwd_pairs": [vp] * 4 + [i] * 5 + [vp],
            "interaction_fwd": [vp] * 8 + [i] * 6 + [vp],
        }
        lib.interaction_fwd_workspace.argtypes = [i] * 4
        lib.interaction_fwd_workspace.restype = ctypes.c_size_t
        for name, argtypes in sig.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i
        _FWD = lib
    return _FWD


def _fwd_dims(t, f: int, e: int, w_bi, bilinear_type: str) -> int:
    """Checks of a forward block's operands on the card (t a bf16/fp32 CUDA
    operand of F fields of width E; w_bi, when given, of the type's shape);
    returns 1 for "each", 0 for "all"."""
    cuda_only("interaction_fwd", t)
    _projected(f, bilinear_type)
    check_fwd_envelope(f, e)
    each = bilinear_type == "each"
    if w_bi is not None and tuple(w_bi.shape) != ((f - 1, e, e) if each else (e, e)):
        raise ValueError(f"w_bi has shape {tuple(w_bi.shape)} for F={f}, E={e}, {bilinear_type}")
    return int(each)


def _launch_fwd(fn, name: str, *args) -> None:
    build.check(getattr(_fwd_fns(), name)(*args), name)
    fn.launches += 1


def fwd_gate(x, w1, b1, w2, b2, *, bilinear_type="all"):
    """Block 1 (see ``fwd_gate_plain``): x (B, F, E) bf16/fp32, SENet
    weights fp32 -> (w, sc)."""
    if x.device.type == "cpu":
        return fwd_gate_plain(x, w1, b1, w2, b2, bilinear_type=bilinear_type)
    b, f, e = x.shape
    each = _fwd_dims(x, f, e, None, bilinear_type)
    r = w1.shape[1]
    f32 = torch.float32
    check_kernel_args({"x": (x, None), "w1": (w1, f32), "b1": (b1, f32), "w2": (w2, f32),
                       "b2": (b2, f32)}, x.dtype, x.device)
    w = torch.empty(b, f, device=x.device)
    sc = torch.empty(f - 1, b, e, dtype=x.dtype, device=x.device)
    _launch_fwd(fwd_gate, "ifwd_gate", *_ptrs(x, w1, b1, w2, b2, w, sc), b, f, e, r, is_bf16(x),
                each, stream_of(x))
    return w, sc


def fwd_project(sc, w_bi, *, bilinear_type="all"):
    """Block 2 (see ``fwd_project_plain``): sc (Q, B, E), w_bi in sc's dtype
    -> V (Q, B, E) in sc's dtype."""
    if sc.device.type == "cpu":
        return fwd_project_plain(sc, w_bi, bilinear_type=bilinear_type)
    q, b, e = sc.shape
    each = _fwd_dims(sc, q + 1, e, w_bi, bilinear_type)
    check_kernel_args({"sc": (sc, None), "w_bi": (w_bi, None)}, sc.dtype, sc.device)
    v = torch.empty_like(sc)
    _launch_fwd(fwd_project, "ifwd_project", *_ptrs(sc, w_bi, v), b, q + 1, e, is_bf16(sc), each,
                stream_of(sc))
    return v


def fwd_pairs(x, w, v, *, bilinear_type="all"):
    """Block 3 (see ``fwd_pairs_plain``): x (B, F, E), V (Q, B, E) in x's
    dtype, w (B, F) fp32 -> (B, (F + F(F-1)/2) E) fp32 (the scoring front
    stores the same values in x's dtype)."""
    if x.device.type == "cpu":
        return fwd_pairs_plain(x, w, v, bilinear_type=bilinear_type)
    b, f, e = x.shape
    each = _fwd_dims(x, f, e, None, bilinear_type)
    check_kernel_args({"x": (x, None), "w": (w, torch.float32), "v": (v, None)},
                      x.dtype, x.device)
    if w.shape != (b, f) or v.shape != (f - 1, b, e):
        raise ValueError("fwd_pairs: w or V do not match x")
    out = torch.empty(b, (f + f * (f - 1) // 2) * e, device=x.device)
    _launch_fwd(fwd_pairs, "ifwd_pairs", *_ptrs(x, w, v, out), b, f, e, is_bf16(x), each,
                stream_of(x))
    return out


@functools.lru_cache(maxsize=64)
def _fwd_workspace(b: int, f: int, e: int, bf16: int) -> int:
    """Bytes of one forward call's workspace at these sizes."""
    return _fwd_fns().interaction_fwd_workspace(b, f, e, bf16)


def interaction_fwd(x, w1, b1, w2, b2, w_bi, *, bilinear_type="all"):
    """x (B, F, E) bf16/fp32; w1 (F, R), b1 (R,), w2 (R, F), b2 (F,) fp32;
    w_bi (E, E) ("all") or (F-1, E, E) ("each") in x's dtype ->
    (B, (F + F(F-1)/2) * E) fp32. On a card: the three blocks, enqueued by
    one C call (``fwd_launches()`` launches)."""
    if x.device.type == "cpu":
        return interaction_fwd_plain(x, w1, b1, w2, b2, w_bi, bilinear_type=bilinear_type)
    cuda_only("interaction_fwd", x)
    if bilinear_type not in ("all", "each"):
        raise ValueError(f"bilinear_type must be 'all' or 'each', got {bilinear_type!r}")
    b, f, e = x.shape
    r = w1.shape[1]
    check_fwd_envelope(f, e)
    wbi_shape = (e, e) if bilinear_type == "all" else (f - 1, e, e)
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
    bf16 = is_bf16(x)
    ws = torch.empty(_fwd_workspace(b, f, e, bf16), dtype=torch.uint8, device=x.device)
    rc = _fwd_fns().interaction_fwd(
        *_ptrs(x, w1, b1, w2, b2, w_bi, out, ws), b, f, e, r, bf16,
        int(bilinear_type == "each"), stream_of(x))
    build.check(rc, "interaction_fwd")
    interaction_fwd.launches += fwd_launches()
    return out


for _fn in (interaction_fwd, fwd_gate, fwd_project, fwd_pairs):
    _fn.launches = 0


# ---------------------------------------------------------------- the backward
#
# Seven building blocks (csrc/interaction_bwd.cu), each a kernel with its
# plain version here; interaction_bwd_plain is their composition. Scratch is
# field-major: the Q = F - 1 projected fields (1..F-1 for "all", 0..F-2 for
# "each") of sc, V and dvc are (Q, B, E).

SPLIT_BLOCKS = 132  # blocks the split dW_bi product aims at: one an SM of an H100
GATE_BLOCKS = 264  # blocks the gate backward aims at: two an SM


def bwd_launches() -> int:
    """Kernel launches of one ``interaction_bwd`` call, either bilinear type
    ("each" runs its per-field products as groups of one launch): the gate,
    V, the pairs, the projection term dvc W^T, the gate backward, dW_bi's
    partials and the reduction."""
    return 7


def check_bwd_envelope(f: int, e: int) -> None:
    """Raise unless the backward kernels take F fields of width E (``fits``)."""
    if not fits(f, e):
        raise ValueError(f"interaction_bwd needs {ENVELOPE}; got F={f}, E={e}")


def weight_grad_split(rows: int, e: int, groups: int) -> tuple[int, int]:
    """(splits, chunk) of dW_bi's product over ``rows`` rows a group: chunk a
    multiple of 64 and about SPLIT_BLOCKS blocks in all over the groups'
    (E/128)^2 output tiles."""
    tiles = (-(-e // 128)) ** 2
    want = max(1, min(SPLIT_BLOCKS // (groups * tiles), -(-rows // 64)))
    chunk = max(64, -(-(-(-rows // want)) // 64) * 64)
    return -(-rows // chunk), chunk


def gate_chunk(b: int) -> int:
    """Rows a block of the gate backward sums into its partial: a multiple
    of 8 giving about GATE_BLOCKS blocks."""
    return max(8, -(-(-(-b // GATE_BLOCKS)) // 8) * 8)


def bwd_gate_plain(x, w1, b1, w2, b2, *, bilinear_type="all", forward_rounding=False):
    """Block 1: x (B, F, E) in cd -> z (B, F), h1 (B, R), w (B, F) fp32 and
    sc = cd(x_p w_p) (Q, B, E) in cd, the gate fp32. ``forward_rounding``:
    sc = x_p cd(w_p) in cd instead, the forward's rounding point."""
    cd = x.dtype
    z = x.float().mean(-1)
    h1 = z @ w1.float() + b1.float()
    w = torch.sigmoid(torch.relu(h1) @ w2.float() + b2.float())
    p = _projected(x.shape[1], bilinear_type)
    if forward_rounding:
        sc = x[:, p] * w[:, p].to(cd)[..., None]
    else:
        sc = (x[:, p].float() * w[:, p, None]).to(cd)
    return z, h1, w, sc.transpose(0, 1).contiguous()


def bwd_project_plain(sc, w_bi, *, bilinear_type="all", forward_rounding=False):
    """Block 2: V = sc W (Q, B, E) fp32, accumulated in fp32 and not rounded
    (``forward_rounding``: rounded to cd, as the forward rounds it)."""
    wf = w_bi.float()
    if bilinear_type == "all":
        v = sc.float() @ wf
    else:
        v = torch.bmm(sc.float(), wf)
    return v.to(sc.dtype).float() if forward_rounding else v


def bwd_pairs_plain(g, x, w, v, *, bilinear_type="all", forward_rounding=False):
    """Block 3: the pairs' backward. g (B, (F + P) E) fp32, x (B, F, E) in
    cd, w (B, F), V (Q, B, E) fp32 -> ds (B, F, E) fp32 (g's S columns plus
    every pair's term, pairs in triu order) and dvc = cd(dv_p) (Q, B, E).
    s = x w in fp32 (``forward_rounding``: x cd(w) in cd)."""
    cd = x.dtype
    b, f, e = x.shape
    s = (x * w.to(cd)[..., None]).float() if forward_rounding else x.float() * w[..., None]
    g = g.float()
    ds = g[:, : f * e].reshape(b, f, e).clone()
    gp = g[:, f * e :].reshape(b, -1, e)
    vb = v.transpose(0, 1)
    i_idx, j_idx = (torch.as_tensor(t, device=x.device) for t in pair_indices(f))
    dv = torch.zeros(b, f - 1, e, device=x.device)
    if bilinear_type == "all":  # p_k = s_i v_j, v_j at q = j - 1
        ds.index_add_(1, i_idx, gp * vb[:, j_idx - 1])
        dv.index_add_(1, j_idx - 1, gp * s[:, i_idx])
    else:  # p_k = v_i s_j
        dv.index_add_(1, i_idx, gp * s[:, j_idx])
        ds.index_add_(1, j_idx, gp * vb[:, i_idx])
    return ds, dv.to(cd).transpose(0, 1).contiguous()


def bwd_project_t_plain(dvc, w_bi, *, bilinear_type="all"):
    """Block 4: the projection term P_p = cd(dv_p) W_p^T (Q, B, E) fp32 of
    each projected field p, which block 5 adds to ds_p."""
    wf = w_bi.float()
    if bilinear_type == "all":
        return dvc.float() @ wf.T
    return torch.bmm(dvc.float(), wf.transpose(1, 2))


def with_projection(ds, p, bilinear_type="all"):
    """ds (B, F, E) with the projection term P (Q, B, E) added at the
    projected fields: the whole of ds, as block 5 reads it."""
    out = ds.clone()
    out[:, _projected(ds.shape[1], bilinear_type)] += p.transpose(0, 1)
    return out


def bwd_gate_dx_plain(ds, p, x, z, h1, w, w1, w2, *, bilinear_type="all"):
    """Block 5: the gate's backward on ds + P (``with_projection``). -> dx =
    cd(ds w + dz / E) (B, F, E) and the gate gradients' partials
    (ceil(B / chunk), 2 F R + R + F) fp32, one a chunk of ``gate_chunk(B)``
    rows, each laid out [dW1 (F, R) | db1 (R) | dW2 (R, F) | db2 (F)]."""
    b, f, e = x.shape
    chunk = gate_chunk(b)
    ds = with_projection(ds, p, bilinear_type)
    dh2 = (ds * x.float()).sum(-1) * w * (1.0 - w)
    dh1 = (dh2 @ w2.float().T) * (h1 > 0)
    dz = dh1 @ w1.float().T
    dx = (ds * w[..., None] + dz[..., None] * (1.0 / e)).to(x.dtype)
    a = torch.relu(h1)
    rows = torch.cat([(z[:, :, None] * dh1[:, None, :]).reshape(b, -1), dh1,
                      (a[:, :, None] * dh2[:, None, :]).reshape(b, -1), dh2], dim=1)
    nblk = -(-b // chunk)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, nblk * chunk - b))
    return dx, rows.reshape(nblk, chunk, -1).sum(1)


def bwd_weight_grad_plain(sc, dvc, *, bilinear_type="all", chunk=None):
    """Block 6: dW_bi's partials (G, splits, E, E) fp32: split s of group g
    sums sc^T dvc over its chunk of the group's rows ("all": one group of
    the Q B rows, which sums the fields; "each": Q groups of B rows). The
    split is ``weight_grad_split``'s unless ``chunk`` is given."""
    q, b, e = sc.shape
    if bilinear_type == "all":
        sc, dvc = sc.reshape(1, q * b, e), dvc.reshape(1, q * b, e)
    groups, rows = sc.shape[0], sc.shape[1]
    if chunk is None:
        _, chunk = weight_grad_split(rows, e, groups)
    splits = -(-rows // chunk)
    pad = (0, 0, 0, splits * chunk - rows)
    a = torch.nn.functional.pad(sc.float(), pad).reshape(groups, splits, chunk, e)
    d = torch.nn.functional.pad(dvc.float(), pad).reshape(groups, splits, chunk, e)
    return torch.einsum("gsre,gsrd->gsed", a, d)


def bwd_reduce_plain(part_bi, part_gate):
    """Block 7: [dW_bi (G E E) | the gate gradients] fp32, each the sum of
    its partials."""
    return torch.cat([part_bi.sum(1).reshape(-1), part_gate.sum(0)])


def interaction_bwd_plain(g, x, w1, b1, w2, b2, w_bi, *, bilinear_type="all",
                          forward_rounding=False):
    """Plain PyTorch version of the backward, the composition of the seven
    blocks' plain versions, at the TPU backward kernel's rounding points
    (not autograd of ``interaction_fwd_plain``): s and v stay fp32, and only
    the operands of the E x E products (s, dv, W) take x's dtype cd. dW_bi
    is one product over all the rows (a single partial), where the kernels
    split it.
    Returns (dx in cd, dW1, db1, dW2, db2, dW_bi), all weight gradients fp32
    and summed over the batch.

    ``forward_rounding=True`` recomputes s and v at the forward's rounding
    points instead (s = cd(x * cd(gate)), v = cd(s W)): a wrong backward that
    the bf16 tolerances of the checks must reject. In fp32 the two agree."""
    _projected(x.shape[1], bilinear_type)
    b, f, e = x.shape
    r = w1.shape[1]
    bt, fr = dict(bilinear_type=bilinear_type), dict(forward_rounding=forward_rounding)
    z, h1, w, sc = bwd_gate_plain(x, w1, b1, w2, b2, **bt, **fr)
    v = bwd_project_plain(sc, w_bi, **bt, **fr)
    ds, dvc = bwd_pairs_plain(g, x, w, v, **bt, **fr)
    p = bwd_project_t_plain(dvc, w_bi, **bt)
    dx, part_gate = bwd_gate_dx_plain(ds, p, x, z, h1, w, w1, w2, **bt)
    rows = b * (f - 1) if bilinear_type == "all" else b
    part_bi = bwd_weight_grad_plain(sc, dvc, **bt, chunk=rows)  # one partial
    wbi_shape = (e, e) if bilinear_type == "all" else (f - 1, e, e)
    dw_bi, dw1, db1, dw2, db2 = torch.split(
        bwd_reduce_plain(part_bi, part_gate), [w_bi.numel(), f * r, r, r * f, f])
    return dx, dw1.view(f, r), db1, dw2.view(r, f), db2, dw_bi.view(wbi_shape)


def interaction_bwd_expr(g, x, w1, b1, w2, b2, w_bi, *, bilinear_type="all"):
    """``interaction_bwd_plain`` as the single expression it was before the
    backward was split into blocks: the same rounding points and function,
    summed in another order. The yardstick of the backward's plain time
    that chip_smoke.py reports beside the composition's. Returns (dx in
    cd, dW1, db1, dW2, db2, dW_bi)."""
    _projected(x.shape[1], bilinear_type)
    cd = x.dtype
    b, f, e = x.shape
    xs, g = x.float(), g.float()
    z = xs.mean(-1)
    h1 = z @ w1.float() + b1.float()
    a = torch.relu(h1)
    w = torch.sigmoid(a @ w2.float() + b2.float())
    s = xs * w[..., None]
    s_cd = s.to(cd).float()
    wf = w_bi.to(cd).float()
    i_idx, j_idx = (torch.as_tensor(t, device=x.device) for t in pair_indices(f))
    ds = g[:, : f * e].reshape(b, f, e).clone()
    gp = g[:, f * e :].reshape(b, -1, e)
    dv = torch.zeros_like(s)
    if bilinear_type == "all":
        v = s_cd @ wf
        ds.index_add_(1, i_idx, gp * v[:, j_idx])
        dv.index_add_(1, j_idx, gp * s[:, i_idx])
        dv_cd = dv.to(cd).float()
        dw_bi = torch.einsum("bfe,bfd->ed", s_cd, dv_cd)
        ds = ds + dv_cd @ wf.T
    else:
        v = torch.einsum("bfe,fed->bfd", s_cd[:, :-1], wf)
        dv[:, :-1].index_add_(1, i_idx, gp * s[:, j_idx])
        ds.index_add_(1, j_idx, gp * v[:, i_idx])
        dv_cd = dv[:, :-1].to(cd).float()
        dw_bi = torch.einsum("bfe,bfd->fed", s_cd[:, :-1], dv_cd)
        ds[:, :-1] += torch.einsum("bfd,fed->bfe", dv_cd, wf)
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
        sig = {
            "ibwd_gate": [vp] * 9 + [i] * 6 + [vp],
            "ibwd_project": [vp] * 3 + [i] * 5 + [vp],
            "ibwd_pairs": [vp] * 6 + [i] * 5 + [vp],
            "ibwd_project_t": [vp] * 3 + [i] * 5 + [vp],
            "ibwd_gate_dx": [vp] * 12 + [i] * 7 + [vp],
            "ibwd_weight_grad": [vp] * 3 + [i] * 7 + [vp],
            "ibwd_reduce": [vp] * 3 + [i] * 5 + [vp],
            "interaction_bwd": [vp] * 10 + [i] * 9 + [vp],
        }
        lib.interaction_bwd_workspace.argtypes = [i] * 8
        lib.interaction_bwd_workspace.restype = ctypes.c_size_t
        for name, argtypes in sig.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i
        _BWD = lib
    return _BWD


def _bwd_dims(t, f: int, e: int, w_bi, bilinear_type: str) -> int:
    """Checks of a block's operands on the card (t a bf16/fp32 CUDA operand
    of F fields of width E; w_bi, when given, in t's dtype of the type's
    shape); returns 1 for "each", 0 for "all"."""
    cuda_only("interaction_bwd", t)
    _projected(f, bilinear_type)
    check_bwd_envelope(f, e)
    each = bilinear_type == "each"
    if w_bi is not None and tuple(w_bi.shape) != ((f - 1, e, e) if each else (e, e)):
        raise ValueError(f"w_bi has shape {tuple(w_bi.shape)} for F={f}, E={e}, {bilinear_type}")
    return int(each)


def _launch(fn, name: str, *args) -> None:
    build.check(getattr(_bwd_fns(), name)(*args), name)
    fn.launches += 1


def bwd_gate(x, w1, b1, w2, b2, *, bilinear_type="all"):
    """Block 1 (see ``bwd_gate_plain``): x (B, F, E) bf16/fp32, SENet
    weights fp32 -> (z, h1, w, sc)."""
    if x.device.type == "cpu":
        return bwd_gate_plain(x, w1, b1, w2, b2, bilinear_type=bilinear_type)
    b, f, e = x.shape
    each = _bwd_dims(x, f, e, None, bilinear_type)
    r = w1.shape[1]
    f32 = torch.float32
    check_kernel_args({"x": (x, None), "w1": (w1, f32), "b1": (b1, f32), "w2": (w2, f32),
                       "b2": (b2, f32)}, x.dtype, x.device)
    z = torch.empty(b, f, device=x.device)
    w = torch.empty(b, f, device=x.device)
    h1 = torch.empty(b, r, device=x.device)
    sc = torch.empty(f - 1, b, e, dtype=x.dtype, device=x.device)
    _launch(bwd_gate, "ibwd_gate", *_ptrs(x, w1, b1, w2, b2, z, h1, w, sc), b, f, e, r,
            is_bf16(x), each, stream_of(x))
    return z, h1, w, sc


def bwd_project(sc, w_bi, *, bilinear_type="all"):
    """Block 2 (see ``bwd_project_plain``): sc (Q, B, E), w_bi in sc's dtype
    -> V (Q, B, E) fp32."""
    if sc.device.type == "cpu":
        return bwd_project_plain(sc, w_bi, bilinear_type=bilinear_type)
    q, b, e = sc.shape
    f = q + 1
    each = _bwd_dims(sc, f, e, w_bi, bilinear_type)
    check_kernel_args({"sc": (sc, None), "w_bi": (w_bi, None)}, sc.dtype, sc.device)
    v = torch.empty(f - 1, b, e, device=sc.device)
    _launch(bwd_project, "ibwd_project", *_ptrs(sc, w_bi, v), b, f, e, is_bf16(sc), each,
            stream_of(sc))
    return v


def bwd_pairs(g, x, w, v, *, bilinear_type="all"):
    """Block 3 (see ``bwd_pairs_plain``) -> (ds (B, F, E) fp32, dvc (Q, B, E)
    in x's dtype)."""
    if x.device.type == "cpu":
        return bwd_pairs_plain(g, x, w, v, bilinear_type=bilinear_type)
    b, f, e = x.shape
    each = _bwd_dims(x, f, e, None, bilinear_type)
    f32 = torch.float32
    check_kernel_args({"g": (g, f32), "x": (x, None), "w": (w, f32), "v": (v, f32)},
                      x.dtype, x.device)
    if g.shape != (b, (f + f * (f - 1) // 2) * e) or w.shape != (b, f) or v.shape != (f - 1, b, e):
        raise ValueError("bwd_pairs: g, w or V do not match x")
    ds = torch.empty(b, f, e, device=x.device)
    dvc = torch.empty(f - 1, b, e, dtype=x.dtype, device=x.device)
    _launch(bwd_pairs, "ibwd_pairs", *_ptrs(g, x, w, v, ds, dvc), b, f, e, is_bf16(x), each,
            stream_of(x))
    return ds, dvc


def bwd_project_t(dvc, w_bi, *, bilinear_type="all"):
    """Block 4 (see ``bwd_project_t_plain``): dvc (Q, B, E), w_bi in its
    dtype -> P (Q, B, E) fp32."""
    if dvc.device.type == "cpu":
        return bwd_project_t_plain(dvc, w_bi, bilinear_type=bilinear_type)
    q, b, e = dvc.shape
    f = q + 1
    each = _bwd_dims(dvc, f, e, w_bi, bilinear_type)
    check_kernel_args({"dvc": (dvc, None), "w_bi": (w_bi, None)}, dvc.dtype, dvc.device)
    p = torch.empty(q, b, e, device=dvc.device)
    _launch(bwd_project_t, "ibwd_project_t", *_ptrs(dvc, w_bi, p), b, f, e, is_bf16(dvc), each,
            stream_of(dvc))
    return p


def bwd_gate_dx(ds, p, x, z, h1, w, w1, w2, *, bilinear_type="all"):
    """Block 5 (see ``bwd_gate_dx_plain``) -> (dx in x's dtype, the gate
    partials (ceil(B / gate_chunk(B)), 2 F R + R + F) fp32)."""
    if x.device.type == "cpu":
        return bwd_gate_dx_plain(ds, p, x, z, h1, w, w1, w2, bilinear_type=bilinear_type)
    b, f, e = x.shape
    each = _bwd_dims(x, f, e, None, bilinear_type)
    r = w1.shape[1]
    chunk = gate_chunk(b)
    f32 = torch.float32
    check_kernel_args({"ds": (ds, f32), "p": (p, f32), "x": (x, None), "z": (z, f32),
                       "h1": (h1, f32), "w": (w, f32), "w1": (w1, f32), "w2": (w2, f32)},
                      x.dtype, x.device)
    if ds.shape != (b, f, e) or p.shape != (f - 1, b, e):
        raise ValueError("bwd_gate_dx: ds or P do not match x")
    dx = torch.empty_like(x)
    dh2, dh1 = torch.empty(b, f, device=x.device), torch.empty(b, r, device=x.device)
    part = torch.empty(-(-b // chunk), 2 * f * r + r + f, device=x.device)
    _launch(bwd_gate_dx, "ibwd_gate_dx", *_ptrs(ds, p, x, z, h1, w, w1, w2, dx, dh2, dh1, part),
            b, f, e, r, chunk, is_bf16(x), each, stream_of(x))
    return dx, part


def bwd_weight_grad(sc, dvc, *, bilinear_type="all"):
    """Block 6 (see ``bwd_weight_grad_plain``): -> dW_bi's partials (G,
    splits, E, E) fp32 at ``weight_grad_split``'s split."""
    if sc.device.type == "cpu":
        return bwd_weight_grad_plain(sc, dvc, bilinear_type=bilinear_type)
    q, b, e = sc.shape
    f = q + 1
    each = _bwd_dims(sc, f, e, None, bilinear_type)
    check_kernel_args({"sc": (sc, None), "dvc": (dvc, None)}, sc.dtype, sc.device)
    groups = f - 1 if each else 1
    splits, chunk = weight_grad_split(b if each else (f - 1) * b, e, groups)
    part = torch.empty(groups, splits, e, e, device=sc.device)
    _launch(bwd_weight_grad, "ibwd_weight_grad", *_ptrs(sc, dvc, part), b, f, e, splits, chunk,
            is_bf16(sc), each, stream_of(sc))
    return part


def bwd_reduce(part_bi, part_gate):
    """Block 7 (see ``bwd_reduce_plain``): each output the sum of its
    partials in index order."""
    if part_bi.device.type == "cpu":
        return bwd_reduce_plain(part_bi, part_gate)
    f32 = torch.float32
    check_kernel_args({"part_bi": (part_bi, f32), "part_gate": (part_gate, f32)}, f32,
                      part_bi.device)
    groups, splits, e, _ = part_bi.shape
    nblk, n_gate = part_gate.shape
    out = torch.empty(groups * e * e + n_gate, device=part_bi.device)
    _launch(bwd_reduce, "ibwd_reduce", *_ptrs(part_bi, part_gate, out), groups, e, splits, nblk,
            n_gate, stream_of(part_bi))
    return out


@functools.lru_cache(maxsize=64)
def _bwd_plan(b: int, f: int, e: int, r: int, bf16: int, each: int) -> tuple:
    """One call's layout at these sizes: (splits, chunk, gate chunk,
    workspace bytes, the five gradients' sizes, dW_bi's shape)."""
    splits, chunk = weight_grad_split(b if each else (f - 1) * b, e, f - 1 if each else 1)
    gchunk = gate_chunk(b)
    ws = _bwd_fns().interaction_bwd_workspace(b, f, e, r, bf16, each, splits, gchunk)
    wbi_shape = (f - 1, e, e) if each else (e, e)
    return splits, chunk, gchunk, ws, (math.prod(wbi_shape), f * r, r, r * f, f), wbi_shape


def interaction_bwd(g, x, w1, b1, w2, b2, w_bi, *, bilinear_type="all"):
    """g (B, (F + F(F-1)/2) * E) fp32 and the forward's operands (x and w_bi
    in the compute dtype, SENet weights fp32) -> (dx, dW1, db1, dW2, db2,
    dW_bi): dx in x's dtype, the weight gradients fp32. On a card: the seven
    blocks, enqueued by one C call (``bwd_launches()`` launches)."""
    if x.device.type == "cpu":
        return interaction_bwd_plain(g, x, w1, b1, w2, b2, w_bi, bilinear_type=bilinear_type)
    cuda_only("interaction_bwd", x)
    each = int(bilinear_type == "each")
    if not each and bilinear_type != "all":
        raise ValueError(f"bilinear_type must be 'all' or 'each', got {bilinear_type!r}")
    b, f, e = x.shape
    r = w1.shape[1]
    check_bwd_envelope(f, e)
    if b == 0:  # no rows: dx is empty and every weight gradient 0
        wbi_shape = (f - 1, e, e) if each else (e, e)
        return (torch.empty_like(x), *(torch.zeros(s, device=x.device) for s in (
            (f, r), (r,), (r, f), (f,), wbi_shape)))
    bf16 = is_bf16(x)
    splits, chunk, gchunk, nbytes, sizes, wbi_shape = _bwd_plan(b, f, e, r, bf16, each)
    if (g.shape, w1.shape, b1.shape, w2.shape, b2.shape, w_bi.shape) != (
            (b, (f + f * (f - 1) // 2) * e), (f, r), (r,), (r, f), (f,), wbi_shape):
        raise ValueError("cotangent / SENet / bilinear weight shapes do not match x")
    f32 = torch.float32
    check_kernel_args(
        {"g": (g, f32), "x": (x, None), "w1": (w1, f32), "b1": (b1, f32),
         "w2": (w2, f32), "b2": (b2, f32), "w_bi": (w_bi, None)},
        x.dtype, x.device,
    )
    out = torch.empty(sum(sizes), dtype=f32, device=x.device)
    dx = torch.empty_like(x)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    rc = _bwd_fns().interaction_bwd(
        *_ptrs(g, x, w1, b1, w2, b2, w_bi, dx, out, ws),
        b, f, e, r, splits, chunk, gchunk, bf16, each, stream_of(x))
    build.check(rc, "interaction_bwd")
    interaction_bwd.launches += bwd_launches()
    dw_bi, dw1, db1, dw2, db2 = torch.split(out, sizes)
    return dx, dw1.view(f, r), db1, dw2.view(r, f), db2, dw_bi.view(wbi_shape)


for _fn in (interaction_bwd, bwd_gate, bwd_project, bwd_pairs, bwd_project_t, bwd_gate_dx,
            bwd_weight_grad, bwd_reduce):
    _fn.launches = 0


class FusedInteraction(torch.autograd.Function):
    """The block with the kernels both ways, as ``jax.custom_vjp`` wraps the
    TPU kernels: it takes the fp32 master weights and returns fp32 weight
    gradients; the cast of W to the compute dtype happens inside, and x (not
    the output) is kept for the backward, which recomputes the rest. Each way
    is a span while a profiler runs: ``interaction.fwd``, ``interaction.bwd``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w_bi, bilinear_type):
        with span("interaction.fwd"):
            w_cd = w_bi.to(x.dtype).contiguous()
            ctx.save_for_backward(x, w1, b1, w2, b2, w_cd)
            ctx.bilinear_type = bilinear_type
            return interaction_fwd(x, w1, b1, w2, b2, w_cd, bilinear_type=bilinear_type)

    @staticmethod
    def backward(ctx, g):
        with span("interaction.bwd"):
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
    (bf16 or fp32, else fp32); gradients reach the fp32 parameters. An E
    that is not a multiple of 8 runs zero-padded (``pad_senet_bilinear``)
    and the padded columns are dropped from the output."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.float()
    b, f, e = x.shape
    w_bi = bilinear_params["w"] if bilinear_type == "all" else bilinear_params["w_each"]
    w1, b1, w2, b2 = senet_weights(senet_params, f)
    ep = padded_width(e)
    if ep != e:
        x = torch.nn.functional.pad(x, (0, ep - e))
        w1, w_bi = pad_senet_bilinear(w1, w_bi, e, ep)
    out = FusedInteraction.apply(x.contiguous(), w1, b1, w2, b2, w_bi, bilinear_type)
    return out if ep == e else out.reshape(b, -1, ep)[..., :e].reshape(b, -1)
