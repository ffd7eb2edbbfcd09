"""The interaction backward's building blocks (ops/cuda/interaction.py) on the CPU.

On a card one ``interaction_bwd`` call is seven launches: the gate with
sc = cd(x_p w_p), V = sc W, the pairs' backward (ds and dvc = cd(dv_p)),
the projection term P_p = dvc_p W_p^T, the gate's backward on ds + P with
dx, dW_bi's split partials and one reduction. Each block's plain version is
held here against the matching intermediate of the JAX kernel's arithmetic
(``_bwd_kernel``, ops/pallas/interaction.py:250) written out in numpy at
the same rounding points, fed that arithmetic's own inputs; the numpy transcription itself is
held against ``jax.vjp`` of the Pallas kernel in interpret mode. Their
composition, ``interaction_bwd_plain``, is held against the single
expression it replaced, and against the Pallas vjp by
tests/test_torch_kernels.py::test_interaction_backward_matches_pallas_vjp.

Tolerances, each with its reason:
- fp32 outputs: rtol 1e-5 and 1e-5 of the output's largest magnitude (the
  same fp32 operations, summed in another order).
- outputs rounded to bf16 (sc, dvc, dx) and everything downstream of such a
  rounding: one bf16 ulp of the largest magnitude (2^-7 of it), where fp32
  sums taken in another order put a rounding one ulp apart, and 2^-12 in
  norm (BWD_NORM_TOL), which a wrong rounding point fails.
- the transcription against the Pallas vjp: the bars of
  test_interaction_backward_matches_pallas_vjp (fp32 1e-5; bf16 2^-7 of the
  largest magnitude and 2^-12 in norm).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.ops.pallas.interaction import fused_senet_bilinear_concat as jax_fused
from ctr_recommendation_tpu_torch.ops.bilinear import pair_indices
from ctr_recommendation_tpu_torch.ops.cuda import interaction as k

torch.set_num_threads(2)

F, B = 6, 37  # B ragged for every chunk and tile
MANY = 12  # past the 8 fields whose rows the kernels keep in registers
BWD_NORM_TOL = 2.0**-12
DTYPES = {"float32": (torch.float32, np.float32), "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16)}


def _cases(widths=(32,), fields=(F, MANY)):
    return [pytest.param(btype, dtype, e, f, id=f"{btype}-{dtype}" + ("" if e == 32 else f"-E{e}")
                         + ("" if f == F else f"-F{f}"))
            for f in fields for e in widths for dtype in DTYPES for btype in ("all", "each")]


def _operands(btype, dtype, e=32, seed=0, b=B, f=F):
    """Seeded numpy operands: x (b, f, e) and w_bi rounded to cd, SENet
    weights (R = f / 2) with biases, and a cotangent g."""
    rng = np.random.default_rng(seed)
    np_cd = DTYPES[dtype][1]
    r = f // 2
    x = rng.standard_normal((b, f, e)).astype(np_cd).astype(np.float32)
    w1, b1 = rng.standard_normal((f, r)).astype(np.float32) / 2, rng.normal(0, 0.1, r)
    w2, b2 = rng.standard_normal((r, f)).astype(np.float32) / 2, rng.normal(0, 0.1, f)
    shape = (e, e) if btype == "all" else (f - 1, e, e)
    w_bi = (rng.standard_normal(shape) / np.sqrt(e)).astype(np_cd).astype(np.float32)
    g = rng.standard_normal((b, (f + f * (f - 1) // 2) * e)).astype(np.float32)
    return dict(x=x, w1=w1, b1=b1.astype(np.float32), w2=w2, b2=b2.astype(np.float32),
                w_bi=w_bi, g=g)


def _jax_bwd_math(ops, btype, dtype):
    """The arithmetic of the JAX ``_bwd_kernel`` in numpy fp32, with its
    casts to cd, on the projected fields (1..F-1 "all", 0..F-2 "each"):
    z, h1, w, sc = cd(s_p), V, ds before and after the projection term P
    = cd(dv_p) W_p^T, dv (fp32), and the gradients dx (in cd), dW1, db1,
    dW2, db2, dW_bi."""
    np_cd = DTYPES[dtype][1]

    def cd(a):
        return np.asarray(a, np.float32).astype(np_cd).astype(np.float32)

    x, g, wb = ops["x"], ops["g"], ops["w_bi"]
    b, f, e = x.shape
    z = x.mean(-1)
    h1 = z @ ops["w1"] + ops["b1"]
    a = np.maximum(h1, 0)
    w = 1 / (1 + np.exp(-(a @ ops["w2"] + ops["b2"])))
    s = x * w[..., None]
    proj = list(range(1, f)) if btype == "all" else list(range(f - 1))
    wq = [wb if btype == "all" else wb[q] for q in range(f - 1)]
    v = {p: cd(s[:, p]) @ wq[q] for q, p in enumerate(proj)}
    ds = [g[:, fi * e : (fi + 1) * e].copy() for fi in range(f)]
    dv = [np.zeros((b, e), np.float32) for _ in range(f)]
    for kk, (i, j) in enumerate(zip(*pair_indices(f))):
        gp = g[:, (f + kk) * e : (f + kk + 1) * e]
        if btype == "all":
            ds[i] = ds[i] + gp * v[j]
            dv[j] = dv[j] + gp * s[:, i]
        else:
            dv[i] = dv[i] + gp * s[:, j]
            ds[j] = ds[j] + gp * v[i]
    ds_pre = np.stack(ds, 1)
    dw, pt = [], []
    for q, p in enumerate(proj):
        dw.append(cd(s[:, p]).T @ cd(dv[p]))
        pt.append(cd(dv[p]) @ wq[q].T)
        ds[p] = ds[p] + pt[-1]
    ds_post = np.stack(ds, 1)
    dh2 = (ds_post * x).sum(-1) * w * (1 - w)
    dh1 = (dh2 @ ops["w2"].T) * (h1 > 0)
    dz = dh1 @ ops["w1"].T
    return dict(
        z=z, h1=h1, w=w, sc=np.stack([cd(s[:, p]) for p in proj]),
        v=np.stack([v[p] for p in proj]), p=np.stack(pt), ds_pre=ds_pre, ds_post=ds_post,
        dv=np.stack([dv[p] for p in proj]),
        dx=cd(ds_post * w[..., None] + dz[..., None] / e), dw1=z.T @ dh1, db1=dh1.sum(0),
        dw2=a.T @ dh2, db2=dh2.sum(0), dw_bi=sum(dw) if btype == "all" else np.stack(dw),
    )


def _pt(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, rounded):
    """fp32 bar, or (``rounded``: downstream of a bf16 rounding) one bf16 ulp
    of the largest magnitude and BWD_NORM_TOL in norm."""
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if rounded:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-7 * scale)
        assert np.linalg.norm(got - want) <= BWD_NORM_TOL * np.linalg.norm(want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("btype, dtype, f", [
    pytest.param(bt, dt, f, id=f"{bt}-{dt}" + ("" if f == F else f"-F{f}"))
    for f in (F, MANY) for dt in DTYPES for bt in ("all", "each")])
def test_numpy_transcription_matches_pallas_vjp(btype, dtype, f):
    """The numpy arithmetic the blocks are held against is the JAX kernel's:
    its dx and weight gradients against jax.vjp of the Pallas kernel."""
    ops = _operands(btype, dtype, seed=1, f=f)
    jd = jnp.dtype(dtype)
    sp = {"fc1": {"w": ops["w1"], "b": ops["b1"]}, "fc2": {"w": ops["w2"], "b": ops["b2"]}}
    bp = {"w" if btype == "all" else "w_each": ops["w_bi"]}
    _, vjp = jax.vjp(lambda s_, b_, x_: jax_fused(s_, b_, x_, bilinear_type=btype, block_b=16),
                     sp, bp, jnp.asarray(ops["x"], jd))
    d_sp, d_bp, d_x = vjp(jnp.asarray(ops["g"]))
    ref = _jax_bwd_math(ops, btype, dtype)
    pairs = [(ref["dx"], d_x), (ref["dw1"], d_sp["fc1"]["w"]), (ref["db1"], d_sp["fc1"]["b"]),
             (ref["dw2"], d_sp["fc2"]["w"]), (ref["db2"], d_sp["fc2"]["b"]),
             (ref["dw_bi"], list(d_bp.values())[0])]
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-7 * np.abs(want).max())
            assert np.linalg.norm(got - want) <= BWD_NORM_TOL * np.linalg.norm(want)


@pytest.mark.parametrize("btype, dtype, e, f", _cases())
def test_gate_plain_matches_jax_math(btype, dtype, e, f):
    ops = _operands(btype, dtype, e, f=f)
    ref = _jax_bwd_math(ops, btype, dtype)
    cd = DTYPES[dtype][0]
    z, h1, w, sc = k.bwd_gate(_pt(ops["x"], cd), *(_pt(ops[n]) for n in ("w1", "b1", "w2", "b2")),
                              bilinear_type=btype)
    assert sc.dtype == cd and sc.shape == (f - 1, B, e)
    for got, name in ((z, "z"), (h1, "h1"), (w, "w")):
        _close(got, ref[name], False)
    _close(sc, ref["sc"], dtype == "bfloat16")


@pytest.mark.parametrize("btype, dtype, e, f", _cases())
def test_project_plain_matches_jax_v(btype, dtype, e, f):
    """V = sc W in fp32, not rounded, on the JAX arithmetic's sc."""
    ops = _operands(btype, dtype, e, seed=2, f=f)
    ref = _jax_bwd_math(ops, btype, dtype)
    cd = DTYPES[dtype][0]
    v = k.bwd_project(_pt(ref["sc"], cd), _pt(ops["w_bi"], cd), bilinear_type=btype)
    assert v.dtype == torch.float32
    _close(v, ref["v"], False)


@pytest.mark.parametrize("btype, dtype, e, f", _cases())
def test_pairs_plain_matches_jax_ds_and_dv(btype, dtype, e, f):
    """ds before the projection term (fp32) and dvc = cd(dv)."""
    ops = _operands(btype, dtype, e, seed=3, f=f)
    ref = _jax_bwd_math(ops, btype, dtype)
    cd = DTYPES[dtype][0]
    ds, dvc = k.bwd_pairs(_pt(ops["g"]), _pt(ops["x"], cd), _pt(ref["w"]), _pt(ref["v"]),
                          bilinear_type=btype)
    assert ds.dtype == torch.float32 and dvc.dtype == cd and dvc.shape == (f - 1, B, e)
    _close(ds, ref["ds_pre"], False)
    np_cd = DTYPES[dtype][1]
    _close(dvc, ref["dv"].astype(np_cd).astype(np.float32), dtype == "bfloat16")


@pytest.mark.parametrize("btype, dtype, e, f", _cases())
def test_project_t_plain_matches_jax_ds(btype, dtype, e, f):
    """The projection term cd(dv_p) W_p^T, and ds after it."""
    ops = _operands(btype, dtype, e, seed=4, f=f)
    ref = _jax_bwd_math(ops, btype, dtype)
    cd, np_cd = DTYPES[dtype]
    p = k.bwd_project_t(_pt(ref["dv"].astype(np_cd).astype(np.float32), cd),
                        _pt(ops["w_bi"], cd), bilinear_type=btype)
    assert p.dtype == torch.float32 and p.shape == (f - 1, B, e)
    _close(p, ref["p"], False)
    ds_pre = _pt(ref["ds_pre"])
    _close(k.with_projection(ds_pre, p, btype), ref["ds_post"], False)
    assert torch.equal(ds_pre, _pt(ref["ds_pre"]))  # with_projection makes a new tensor


@pytest.mark.parametrize("btype, dtype, e, f", _cases())
def test_gate_dx_plain_matches_jax(btype, dtype, e, f):
    """dx, and the gate partials summed, against the JAX arithmetic's dx and
    SENet gradients."""
    ops = _operands(btype, dtype, e, seed=5, f=f)
    ref = _jax_bwd_math(ops, btype, dtype)
    cd = DTYPES[dtype][0]
    dx, part = k.bwd_gate_dx(_pt(ref["ds_pre"]), _pt(ref["p"]), _pt(ops["x"], cd),
                             _pt(ref["z"]), _pt(ref["h1"]), _pt(ref["w"]), _pt(ops["w1"]),
                             _pt(ops["w2"]), bilinear_type=btype)
    chunk, r = k.gate_chunk(B), f // 2
    assert dx.dtype == cd and part.shape == (-(-B // chunk), 2 * f * r + r + f)
    _close(dx, ref["dx"], dtype == "bfloat16")
    dw1, db1, dw2, db2 = torch.split(part.sum(0), [f * r, r, r * f, f])
    for got, name in ((dw1.view(f, r), "dw1"), (db1, "db1"), (dw2.view(r, f), "dw2"),
                      (db2, "db2")):
        _close(got, ref[name], False)


@pytest.mark.parametrize("btype, dtype, e, f", _cases())
def test_weight_grad_plain_matches_jax_dw(btype, dtype, e, f):
    """dW_bi's partials, one a chunk of rows, summed: the JAX arithmetic's
    cd(s_p)^T cd(dv_p) summed over the projected fields ("all")."""
    ops = _operands(btype, dtype, e, seed=6, f=f)
    ref = _jax_bwd_math(ops, btype, dtype)
    cd, np_cd = DTYPES[dtype]
    dvc = _pt(ref["dv"].astype(np_cd).astype(np.float32), cd)
    part = k.bwd_weight_grad(_pt(ref["sc"], cd), dvc, bilinear_type=btype)
    groups = 1 if btype == "all" else f - 1
    splits, _ = k.weight_grad_split(B * (f - 1) if btype == "all" else B, e, groups)
    assert part.shape == (groups, splits, e, e)
    got = part.sum(1)
    _close(got[0] if btype == "all" else got, ref["dw_bi"], False)


@pytest.mark.parametrize("chunk", [64, 128])
def test_weight_grad_partials_split_the_rows(chunk):
    """Split s holds exactly the product over rows [s chunk, (s + 1) chunk)."""
    rng = np.random.default_rng(7)
    sc = torch.from_numpy(rng.standard_normal((F - 1, 100, 16)).astype(np.float32))
    dvc = torch.from_numpy(rng.standard_normal((F - 1, 100, 16)).astype(np.float32))
    part = k.bwd_weight_grad_plain(sc, dvc, bilinear_type="all", chunk=chunk)
    a, d = sc.reshape(-1, 16), dvc.reshape(-1, 16)
    assert part.shape == (1, -(-500 // chunk), 16, 16)
    for s in range(part.shape[1]):
        rows = slice(s * chunk, (s + 1) * chunk)
        torch.testing.assert_close(part[0, s], a[rows].T @ d[rows], rtol=1e-5, atol=1e-5)


def test_reduce_plain_sums_each_kind_of_partial():
    rng = np.random.default_rng(8)
    part_bi = torch.from_numpy(rng.standard_normal((5, 3, 8, 8)).astype(np.float32))
    part_gate = torch.from_numpy(rng.standard_normal((4, 45)).astype(np.float32))
    out = k.bwd_reduce(part_bi, part_gate)
    want = np.concatenate([part_bi.double().numpy().sum(1).reshape(-1),
                           part_gate.double().numpy().sum(0)])
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("btype, dtype, e, f", _cases((32, 256), (F,)) + _cases((32,), (MANY,)))
def test_interaction_bwd_plain_is_the_composition_of_the_blocks(btype, dtype, e, f):
    """interaction_bwd_plain == the seven blocks in order (dW_bi's product
    in one partial), and within the fp32 bar (bf16: the rounded dx within
    one ulp) of the single expression it was before (interaction_bwd_expr)."""
    ops = _operands(btype, dtype, e, seed=9, f=f)
    cd = DTYPES[dtype][0]
    x, g, w_bi = _pt(ops["x"], cd), _pt(ops["g"]), _pt(ops["w_bi"], cd)
    sw = [_pt(ops[n]) for n in ("w1", "b1", "w2", "b2")]
    got = k.interaction_bwd_plain(g, x, *sw, w_bi, bilinear_type=btype)
    kw = dict(bilinear_type=btype)
    z, h1, w, sc = k.bwd_gate_plain(x, *sw, **kw)
    ds, dvc = k.bwd_pairs_plain(g, x, w, k.bwd_project_plain(sc, w_bi, **kw), **kw)
    p = k.bwd_project_t_plain(dvc, w_bi, **kw)
    dx, part_gate = k.bwd_gate_dx_plain(ds, p, x, z, h1, w, sw[0], sw[2], **kw)
    rows = B * (f - 1) if btype == "all" else B
    out = k.bwd_reduce_plain(k.bwd_weight_grad_plain(sc, dvc, **kw, chunk=rows), part_gate)
    assert torch.equal(got[0], dx)
    flat = torch.cat([got[5].reshape(-1), *(t.reshape(-1) for t in got[1:5])])
    assert torch.equal(flat, out)
    for a, p in zip(got, k.interaction_bwd_expr(g, x, *sw, w_bi, bilinear_type=btype)):
        assert a.dtype == p.dtype and a.shape == p.shape
        _close(a, p.float().numpy(), a.dtype == torch.bfloat16)


def test_bwd_launches():
    """Seven launches a call for either type: "each" runs its per-field
    products as groups of one launch."""
    assert k.bwd_launches() == 7


@pytest.mark.parametrize("f, e", [(1, 32), (0, 32), (6, 12), (6, 0)])
def test_envelope_refusals_name_the_envelope(f, e):
    with pytest.raises(ValueError, match="interaction_bwd needs F >= 2 and E % 8 == 0"):
        k.check_bwd_envelope(f, e)


@pytest.mark.parametrize("f, e", [(2, 8), (6, 32), (6, 256), (8, 136), (9, 32), (40, 128)])
def test_envelope_takes(f, e):
    k.check_bwd_envelope(f, e)


@pytest.mark.parametrize("rows, e, groups", [(37, 32, 1), (5 * 4096, 128, 1), (4133, 128, 5),
                                             (5 * 4096, 256, 1), (4096, 256, 5)])
def test_weight_grad_split_covers_the_rows(rows, e, groups):
    """Chunks are multiples of 64 (the tile product's deepest slice) that
    cover the rows with no empty split, about one block an SM in all."""
    splits, chunk = k.weight_grad_split(rows, e, groups)
    assert chunk % 64 == 0 and splits * chunk >= rows > (splits - 1) * chunk
    assert splits * groups * (-(-e // 128)) ** 2 <= k.SPLIT_BLOCKS


@pytest.mark.parametrize("b", [1, 37, 4096, 4133])
def test_gate_chunk(b):
    chunk = k.gate_chunk(b)
    assert chunk % 8 == 0 and -(-b // chunk) <= k.GATE_BLOCKS


@pytest.mark.cuda
@pytest.mark.parametrize("btype, dtype, e, f", [
    pytest.param(bt, dt, e, f, id=f"{bt}-{dt}-E{e}" + ("" if f == F else f"-F{f}"))
    for e, f in ((128, F), (256, F), (64, MANY)) for dt in DTYPES for bt in ("all", "each")])
def test_blocks_match_plain_on_the_card(btype, dtype, e, f):
    """On a card: each block's kernel against its plain version on the
    plain version's inputs (ragged B), within the bars above, and
    bit-identical on a repeat launch. chip_smoke.py runs the same check at
    the training batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ops = _operands(btype, dtype, e, seed=10, b=333, f=f)
    cd = DTYPES[dtype][0]
    x, g, w_bi = (_pt(ops["x"], cd).cuda(), _pt(ops["g"]).cuda(), _pt(ops["w_bi"], cd).cuda())
    sw = [_pt(ops[n]).cuda() for n in ("w1", "b1", "w2", "b2")]
    kw = dict(bilinear_type=btype)
    z, h1, w, sc = k.bwd_gate_plain(x, *sw, **kw)
    v = k.bwd_project_plain(sc, w_bi, **kw)
    ds, dvc = k.bwd_pairs_plain(g, x, w, v, **kw)
    p = k.bwd_project_t_plain(dvc, w_bi, **kw)
    dx, part_gate = k.bwd_gate_dx_plain(ds, p, x, z, h1, w, sw[0], sw[2], **kw)
    part_bi = k.bwd_weight_grad_plain(sc, dvc, **kw)
    cases = [
        (lambda: k.bwd_gate(x, *sw, **kw), (z, h1, w, sc)),
        (lambda: k.bwd_project(sc, w_bi, **kw), (v,)),
        (lambda: k.bwd_pairs(g, x, w, v, **kw), (ds, dvc)),
        (lambda: k.bwd_project_t(dvc, w_bi, **kw), (p,)),
        (lambda: k.bwd_gate_dx(ds, p, x, z, h1, w, sw[0], sw[2], **kw), (dx, part_gate)),
        (lambda: k.bwd_weight_grad(sc, dvc, **kw), (part_bi,)),
        (lambda: k.bwd_reduce(part_bi, part_gate), (k.bwd_reduce_plain(part_bi, part_gate),)),
    ]
    for kernel, want in cases:
        got, again = kernel(), kernel()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        for a, c, wt in zip(got, again, want):
            assert torch.equal(a, c)
            _close(a.cpu(), wt.float().cpu().numpy(), dtype == "bfloat16")
