"""The interaction forward's building blocks (ops/cuda/interaction.py) on the CPU.

On a card one ``interaction_fwd`` call is three launches: the gate (w and
sc = cd(x_p cd(w_p)), field-major (F-1, B, E)), V = cd(sc W) on the tile
product, and the pairs pass writing [S | pairs]. Each block's plain version
is held here against the JAX package's forward: ``fused_senet_bilinear_concat``
through its Pallas kernel in interpret mode, as the JAX package's own tests
run it on the CPU, with the kernel's intermediates (the gate w, S, V, the
output) taken from the same arithmetic written out in jnp at its rounding
points (``_kernel_all`` :56, ``_kernel_each`` :94), op by op, and that jnp
arithmetic held against the Pallas kernel's output. Weights are
JAX-initialised (SENet biases moved off 0 with seeded numpy) and reach the
port through ``tools/jax_bridge``'s flat form; x is seeded numpy. The
blocks' plain versions, composed, are ``interaction_fwd_plain`` bit for bit,
and in the compute dtype the scoring front's concat bit for bit.

Tolerances, each with its reason:
- fp32: rtol 1e-5 and 1e-5 of the output's largest magnitude (the same fp32
  operations, summed in another order by XLA and PyTorch).
- bf16 values rounded to bf16 (sc = S, V) and the output built from them:
  one bf16 ulp elementwise (2^-7 relative; 2^-6 for a pair product, which
  carries two roundings) above a floor of 1e-5 of the largest magnitude (a
  V near 0 after cancellation keeps only the fp32 sums' noise), and 2^-12
  in norm (FWD_NORM_TOL of chip_smoke.py): fp32 sums taken in another order
  land a rounding one ulp apart in a few elements, while a forward that
  takes V unrounded into the pair products moves every pair element and
  fails the norm bar (the control below).
- the jnp arithmetic against the Pallas kernel: the fp32 bar; in bf16 about
  one ulp elementwise (2^-6 relative over the same floor: S, V and their
  product each rounded on one side only) and no norm bar, because XLA on
  the CPU fuses the interpret-mode kernel and keeps S and V at fp32
  precision there (excess precision), where the kernel's code, the jnp
  arithmetic op by op, the port and its kernels round them to bf16: about
  one ulp in most bf16 elements, 1.6e-3 in norm. So the bf16 norm bars
  hold against the jnp arithmetic, and against the Pallas kernel only
  elementwise.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.ops import bilinear as jax_bilinear
from ctr_recommendation_tpu.ops import senet as jax_senet
from ctr_recommendation_tpu.ops.pallas.interaction import fused_senet_bilinear_concat as jax_fused
from ctr_recommendation_tpu_torch.ops.bilinear import pair_indices
from ctr_recommendation_tpu_torch.ops.cuda import interaction as k
from ctr_recommendation_tpu_torch.ops.cuda import scoring as k_score
from ctr_recommendation_tpu_torch.tools import jax_bridge

torch.set_num_threads(2)

F, B = 6, 37  # B ragged for every tile
MANY = 12  # past the 8 fields whose S the pairs pass keeps in registers
FWD_NORM_TOL = 2.0**-12
DTYPES = {"float32": (torch.float32, np.float32), "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16)}


def _cases(widths=(32, 256), fields=(F, MANY), dtypes=tuple(DTYPES)):
    return [pytest.param(btype, dtype, e, f,
                         id=f"{btype}-{dtype}-E{e}" + ("" if f == F else f"-F{f}"))
            for f in fields for e in widths for dtype in dtypes for btype in ("all", "each")]


@functools.lru_cache(maxsize=None)
def _jax_case(btype, dtype, e, f, seed=0):
    """JAX weights and numpy x for one case, the Pallas kernel's output and
    its arithmetic in jnp: (ops, out, recomputed, w, s, v), numpy fp32 (s
    (B, F, E), v the projected fields (B, F-1, E)); ops holds the operands
    as the port takes them."""
    rng = np.random.default_rng(seed + e + f)
    sp = jax.tree_util.tree_map(np.asarray, jax_senet.init(jax.random.key(seed + 1), f, 2))
    sp["fc1"]["b"] = sp["fc1"]["b"] + rng.normal(0, 0.1, sp["fc1"]["b"].shape).astype(np.float32)
    sp["fc2"]["b"] = sp["fc2"]["b"] + rng.normal(0, 0.1, f).astype(np.float32)
    bp = jax.tree_util.tree_map(np.asarray, jax_bilinear.init(jax.random.key(seed + 2), e, f,
                                                              btype))
    x = rng.standard_normal((B, f, e)).astype(DTYPES[dtype][1])
    jd = jnp.dtype(dtype)
    out = np.asarray(jax_fused(sp, bp, jnp.asarray(x, jd), bilinear_type=btype), np.float32)
    # the kernel's arithmetic in jnp, at its rounding points
    xj = jnp.asarray(x, jd)
    f32 = jnp.float32
    z = jnp.mean(xj.astype(f32), axis=-1)
    a = jnp.maximum(jnp.dot(z, sp["fc1"]["w"], preferred_element_type=f32) + sp["fc1"]["b"], 0.0)
    w = jax.nn.sigmoid(jnp.dot(a, sp["fc2"]["w"], preferred_element_type=f32) + sp["fc2"]["b"])
    s = xj * w[..., None].astype(jd)
    wb = jnp.asarray(bp["w"] if btype == "all" else bp["w_each"]).astype(jd)
    proj = s[:, 1:] if btype == "all" else s[:, :-1]
    spec = "bfe,ed->bfd" if btype == "all" else "bfe,fed->bfd"
    # projected fields; bf16 products are exact in fp32, which sums them
    v = jnp.einsum(spec, proj.astype(f32), wb.astype(f32)).astype(jd)
    i_idx, j_idx = pair_indices(f)
    p = s[:, i_idx] * v[:, j_idx - 1] if btype == "all" else v[:, i_idx] * s[:, j_idx]
    recomputed = jnp.concatenate([s.reshape(B, -1), p.reshape(B, -1)], -1).astype(f32)
    # the weights through the bridge's flat form, as the port's tensors
    flat = jax_bridge.flatten({"senet": sp, "bilinear": bp})
    tree = jax_bridge.unflatten({n: torch.from_numpy(np.array(t, np.float32))
                                 for n, t in flat.items()})
    cd = DTYPES[dtype][0]
    ops = dict(x=torch.from_numpy(np.asarray(x, np.float32)).to(cd),
               sw=k.senet_weights(tree["senet"], f),
               w_bi=tree["bilinear"]["w" if btype == "all" else "w_each"].to(cd).contiguous())
    as_np = [np.array(t.astype(f32)) for t in (recomputed, w, s, v)]
    return ops, out, *as_np


def _close(got, want, rounded, rtol=2.0**-7):
    """The fp32 bar, or (``rounded``: a bf16 value or built from them) one
    bf16 ulp (``rtol``) elementwise and FWD_NORM_TOL in norm."""
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if rounded:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * np.abs(want).max())
        assert np.linalg.norm(got - want) <= FWD_NORM_TOL * np.linalg.norm(want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("btype, dtype, e, f", _cases())
def test_jnp_arithmetic_matches_pallas_kernel(btype, dtype, e, f):
    """The intermediates the blocks are held against are the JAX kernel's:
    the jnp arithmetic's output against the Pallas kernel's (bf16: one ulp
    elementwise, the kernel's fused excess precision aside)."""
    _, out, recomputed, *_ = _jax_case(btype, dtype, e, f)
    if dtype == "bfloat16":
        np.testing.assert_allclose(recomputed, out, rtol=2.0**-6, atol=1e-5 * np.abs(out).max())
    else:
        _close(torch.from_numpy(recomputed), out, False)


@pytest.mark.parametrize("btype, dtype, e, f", _cases())
def test_gate_plain_matches_jax(btype, dtype, e, f):
    """w (fp32) and sc = x_p cd(w_p), the projected fields of the JAX S."""
    ops, _, _, w, s, _ = _jax_case(btype, dtype, e, f)
    got_w, sc = k.fwd_gate(ops["x"], *ops["sw"], bilinear_type=btype)
    assert got_w.dtype == torch.float32 and sc.dtype == ops["x"].dtype
    assert sc.shape == (f - 1, B, e)
    _close(got_w, w, False)
    proj = s[:, 1:] if btype == "all" else s[:, :-1]
    _close(sc, proj.transpose(1, 0, 2), dtype == "bfloat16")


@pytest.mark.parametrize("btype, dtype, e, f", _cases())
def test_project_plain_matches_jax_v(btype, dtype, e, f):
    """V = cd(sc W) on the JAX arithmetic's S, field-major, in cd."""
    ops, _, _, _, s, v = _jax_case(btype, dtype, e, f)
    cd = ops["x"].dtype
    proj = s[:, 1:] if btype == "all" else s[:, :-1]
    sc = torch.from_numpy(np.ascontiguousarray(proj.transpose(1, 0, 2))).to(cd)
    got = k.fwd_project(sc, ops["w_bi"], bilinear_type=btype)
    assert got.dtype == cd and got.shape == (f - 1, B, e)
    _close(got, v.transpose(1, 0, 2), dtype == "bfloat16")


@pytest.mark.parametrize("btype, dtype, e, f", _cases())
def test_pairs_plain_matches_jax_output(btype, dtype, e, f):
    """[S | pairs] from the JAX arithmetic's w and V against its output, and
    against the Pallas kernel's (bf16: elementwise, as above)."""
    ops, out, recomputed, w, _, v = _jax_case(btype, dtype, e, f)
    cd = ops["x"].dtype
    vt = torch.from_numpy(np.ascontiguousarray(v.transpose(1, 0, 2))).to(cd)
    got = k.fwd_pairs(ops["x"], torch.from_numpy(w), vt, bilinear_type=btype)
    assert got.dtype == torch.float32
    _close(got, recomputed, dtype == "bfloat16", rtol=2.0**-6)
    if dtype == "bfloat16":
        np.testing.assert_allclose(got.double().numpy(), out, rtol=2.0**-6,
                                   atol=1e-5 * np.abs(out).max())
    else:
        _close(got, out, False)


@pytest.mark.parametrize("btype, dtype, e, f", _cases())
def test_blocks_compose_to_interaction_fwd_plain(btype, dtype, e, f):
    """gate -> project -> pairs is interaction_fwd_plain bit for bit, and
    with the output in cd the scoring front's concat bit for bit."""
    ops, *_ = _jax_case(btype, dtype, e, f)
    x, sw, w_bi = ops["x"], ops["sw"], ops["w_bi"]
    kw = dict(bilinear_type=btype)
    w, sc = k.fwd_gate_plain(x, *sw, **kw)
    v = k.fwd_project_plain(sc, w_bi, **kw)
    want = k.interaction_fwd_plain(x, *sw, w_bi, **kw)
    assert torch.equal(k.fwd_pairs_plain(x, w, v, **kw), want)
    front = k.fwd_pairs_plain(x, w, v, **kw, out_dtype=x.dtype)
    assert front.dtype == x.dtype
    assert torch.equal(front, k_score.score_front_plain(x, *sw, w_bi, **kw))
    assert torch.equal(front, want.to(x.dtype))


@pytest.mark.parametrize("btype, dtype, e, f", _cases(dtypes=("bfloat16",)))
def test_bf16_forward_bar_rejects_unrounded_v(btype, dtype, e, f):
    """The control, the pairs taken with V left in fp32
    (fwd_project_plain(..., forward_rounding=False)), stays within the
    elementwise bf16 bar of chip_smoke.py's TOL against the JAX kernel's
    arithmetic but fails the norm bar, which the right rounding passes."""
    ops, _, out, *_ = _jax_case(btype, dtype, e, f)
    kw = dict(bilinear_type=btype)
    w, sc = k.fwd_gate_plain(ops["x"], *ops["sw"], **kw)
    wrong = k.fwd_pairs_plain(ops["x"], w, k.fwd_project_plain(
        sc, ops["w_bi"], **kw, forward_rounding=False), **kw).double().numpy()
    np.testing.assert_allclose(wrong, out, rtol=2.0**-6, atol=1e-3)
    assert np.linalg.norm(wrong - out) > 2 * FWD_NORM_TOL * np.linalg.norm(out)
    right = k.interaction_fwd_plain(ops["x"], *ops["sw"], ops["w_bi"], **kw).double().numpy()
    assert np.linalg.norm(right - out) <= FWD_NORM_TOL * np.linalg.norm(out)


def test_fwd_launches():
    """Three launches a call for either type ("each" runs its per-field
    products as groups of one launch); the scoring call's front is the
    same three."""
    assert k.fwd_launches() == 3
    assert k_score.score_launches() == k.fwd_launches() + 3


def test_cpu_tensors_take_the_plain_versions():
    ops, *_ = _jax_case("all", "float32", 32, F)
    before = [fn.launches for fn in (k.interaction_fwd, k.fwd_gate, k.fwd_project, k.fwd_pairs)]
    w, sc = k.fwd_gate(ops["x"], *ops["sw"])
    k.fwd_pairs(ops["x"], w, k.fwd_project(sc, ops["w_bi"]))
    k.interaction_fwd(ops["x"], *ops["sw"], ops["w_bi"])
    assert [fn.launches for fn in (k.interaction_fwd, k.fwd_gate, k.fwd_project,
                                   k.fwd_pairs)] == before


@pytest.mark.parametrize("f, e", [(1, 32), (0, 32), (6, 12), (6, 0), (6, 4)])
def test_envelope_refusals_name_the_envelope(f, e):
    with pytest.raises(ValueError, match="interaction_fwd needs F >= 2 and E % 8 == 0"):
        k.check_fwd_envelope(f, e)


@pytest.mark.parametrize("f, e", [(2, 8), (6, 32), (6, 256), (8, 136), (9, 32), (12, 64),
                                  (40, 128), (6, 1024)])
def test_envelope_takes(f, e):
    """No shared-memory row tile bounds E or F any more."""
    k.check_fwd_envelope(f, e)


def test_block_wrappers_refuse_other_devices():
    x = torch.zeros(2, F, 32, device="meta")
    w = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k.fwd_gate(x, w, w, w, w)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k.fwd_project(torch.zeros(F - 1, 2, 32, device="meta"), w)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k.fwd_pairs(x, w, w)


@pytest.mark.cuda
@pytest.mark.parametrize("btype, dtype, e, f", [
    pytest.param(bt, dt, e, f, id=f"{bt}-{dt}-E{e}" + ("" if f == F else f"-F{f}"))
    for e, f in ((128, F), (256, F), (64, MANY)) for dt in DTYPES for bt in ("all", "each")])
def test_blocks_match_plain_on_the_card(btype, dtype, e, f):
    """On a card: each block's kernel against its plain version on the
    plain version's inputs (ragged B), and the whole call against
    interaction_fwd_plain, within the bars above; each bit-identical on a
    repeat launch. chip_smoke.py runs the same checks at the serving
    batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ops, *_ = _jax_case(btype, dtype, e, f)
    x, w_bi = ops["x"].cuda(), ops["w_bi"].cuda()
    sw = [t.cuda() for t in ops["sw"]]
    kw = dict(bilinear_type=btype)
    w, sc = k.fwd_gate_plain(x, *sw, **kw)
    v = k.fwd_project_plain(sc, w_bi, **kw)
    cases = [
        (lambda: k.fwd_gate(x, *sw, **kw), (w, sc)),
        (lambda: k.fwd_project(sc, w_bi, **kw), (v,)),
        (lambda: k.fwd_pairs(x, w, v, **kw), (k.fwd_pairs_plain(x, w, v, **kw),)),
        (lambda: k.interaction_fwd(x, *sw, w_bi, **kw),
         (k.interaction_fwd_plain(x, *sw, w_bi, **kw),)),
    ]
    for kernel, want in cases:
        got, again = kernel(), kernel()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        for a, c, wt in zip(got, again, want):
            assert torch.equal(a, c) and a.dtype == wt.dtype
            _close(a.cpu(), wt.float().cpu().numpy(), dtype == "bfloat16", rtol=2.0**-6)
