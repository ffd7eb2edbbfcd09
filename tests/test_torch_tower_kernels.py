"""The tower kernels (csrc/tower.cu, ops/cuda/tower.py) on a card.

Each block against its plain version, the whole layer (``TowerLayer``)
against the plain blocks and against the library composition it replaces
(``ops/mlp.py``: the bias add, ``_batch_norm``, ``torch.relu``, dropout's
select), the running statistics, every gradient (x, W, b, gamma, beta),
repeats bit for bit, the launch counters, the C plan, a layer on no rows,
and a data-parallel step over a one-rank group. Skipped without a card; imports no JAX, so on a
card's machine without it: ``python -m pytest --noconftest
tests/test_torch_tower_kernels.py``.

Tolerances, and why:

* kernel against plain, fp32 in both: the same formulas with the sums added
  in another order, so the statistics differ by fp32 rounding. Outputs and
  dh in cd within ``ULP[cd]`` of |ref| (a bf16 result may round to the next
  value) plus ``ABS`` of the tensor's largest |ref| (a gate at z within
  rounding of 0); column sums within ``SUM_TOL`` of the column's sum of
  |terms| (fp32 sums of up to 131,072 terms in two orders).
* the kernels and the composition against the exact layer (fp64, the same
  x and W, every ReLU decision the kernels'): the composition adds the
  bias in cd, rounds every step of the normalisation to cd and takes rsqrt
  in cd, the kernels keep fp32 inside. Each norm gap of the kernels
  (outputs, running statistics, gradients) within ``COMPOSED[cd]`` of the
  exact norm, or within the composition's own gap where that is larger
  (in bf16 at 131,072 rows the composition's dW is ~3% off).
* running statistics: within ``STATE_TOL`` relative (fp32 sums).
* repeats: bit for bit (no atomics; every order fixed by the shapes).
"""

from __future__ import annotations

import os
import socket

import pytest
import torch

from ctr_recommendation_tpu_torch.ops import mlp
from ctr_recommendation_tpu_torch.ops.cuda import tower
from ctr_recommendation_tpu_torch.ops.initializers import linear_apply
from ctr_recommendation_tpu_torch.parallel import data_parallel

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card"),
]

ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -20}
ABS = 1e-5
SUM_TOL = 1e-5
COMPOSED = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
STATE_TOL = 1e-5
IN_DIM = 96


def _case(rows, n, dtype, bn, rate, weights, seed=0):
    """A layer's inputs on the card: x, the layer's parameters and state,
    the uniforms, the row weights ("none", "mixed" or "zero") and a
    cotangent."""
    g = torch.Generator().manual_seed(seed + 1000 * n + rows)
    layer = {"linear": {"w": torch.randn(IN_DIM, n, generator=g) / IN_DIM ** 0.5,
                        "b": 0.5 * torch.randn(n, generator=g)}}
    st = {}
    if bn:
        layer["bn_scale"] = 1 + 0.2 * torch.randn(n, generator=g)
        layer["bn_bias"] = 0.2 * torch.randn(n, generator=g)
        st = {"bn_mean": 0.1 * torch.randn(n, generator=g),
              "bn_var": 0.5 + torch.rand(n, generator=g)}
    x = (torch.randn(rows, IN_DIM, generator=g) + 0.3).to(dtype)
    u = torch.rand(rows, n, generator=g) if rate > 0 else None
    w = {"none": None, "mixed": (torch.rand(rows, generator=g) > 0.25).float(),
         "zero": torch.zeros(rows)}[weights]
    dout = torch.randn(rows, n, generator=g).to(dtype)
    cuda = lambda t: None if t is None else t.cuda()  # noqa: E731
    layer = {k: ({kk: cuda(vv) for kk, vv in v.items()} if isinstance(v, dict) else cuda(v))
             for k, v in layer.items()}
    return (cuda(x), layer, {k: cuda(v) for k, v in st.items()}, cuda(u), cuda(w), cuda(dout))


def _leaves(x, layer):
    leaves = [x, layer["linear"]["w"], layer["linear"]["b"]]
    leaves += [layer[k] for k in ("bn_scale", "bn_bias") if k in layer]
    return [t.detach().clone().requires_grad_() for t in leaves]


def _rebuild(layer, leaves):
    out = {"linear": {"w": leaves[1], "b": leaves[2]}}
    if len(leaves) > 3:
        out["bn_scale"], out["bn_bias"] = leaves[3], leaves[4]
    return out


def _fused(x, layer, st, u, w, rate, dout):
    """The layer on the kernels: (out, running, gradients of x, W, b,
    gamma, beta)."""
    leaves = _leaves(x, layer)
    lay = _rebuild(layer, leaves)
    y = leaves[0] @ lay["linear"]["w"].to(x.dtype)
    out, running = tower.TowerLayer.apply(
        y, lay["linear"]["b"], lay.get("bn_scale"), lay.get("bn_bias"), u, w,
        st.get("bn_mean"), st.get("bn_var"), 1.0 - rate, None)
    grads = torch.autograd.grad(out, leaves, dout)
    return out.detach(), running, grads


def _composed(x, layer, st, u, w, rate, dout, gates):
    """The library composition the kernels replace, with autograd, its ReLU
    taking ``gates`` (the kernels' decisions): (out, new state, gradients,
    the largest |pre-activation| / max where its own decision differs)."""
    leaves = _leaves(x, layer)
    lay = _rebuild(layer, leaves)
    h = linear_apply(lay["linear"], leaves[0])
    new_st = st
    if "bn_scale" in lay:
        h, new_st = mlp._batch_norm(lay, st, h, True, w)
    differ = gates != (h > 0)
    margin = float(h.detach()[differ].abs().max() / h.detach().abs().max()) \
        if bool(differ.any()) else 0.0
    h = torch.where(gates, h, 0.0)
    if u is not None:
        keep = 1.0 - rate
        h = torch.where(u < keep, h / keep, 0.0)
    grads = torch.autograd.grad(h, leaves, dout)
    return h.detach(), new_st, grads, margin


def _close(name, got, want, rel, abs_scale=ABS):
    got, want = got.double(), want.double()
    bar = rel * want.abs() + abs_scale * want.abs().max().clamp(min=1e-30)
    bad = (got - want).abs() > bar
    assert not bool(bad.any()), (f"{name}: {int(bad.sum())} of {bad.numel()} elements off, "
                                 f"max|d| {(got - want).abs().max().item():.3e}")


def _norm_gap(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def _sums_close(name, got, want, terms):
    """Column sums of ``terms`` (rows, k) in two orders: within SUM_TOL of
    the column's sum of |terms|."""
    bar = SUM_TOL * terms.double().abs().sum(0) + 1e-30
    assert bool(((got.double() - want.double()).abs() <= bar).all()), name


def _check_layer(rows, n, dtype, bn, rate, weights):
    x, layer, st, u, w, dout = _case(rows, n, dtype, bn, rate, weights)
    out_k, run_k, g_k = _fused(x, layer, st, u, w, rate, dout)
    keep = 1.0 - rate
    b, gamma, beta = layer["linear"]["b"], layer.get("bn_scale"), layer.get("bn_bias")
    rm, rv = st.get("bn_mean"), st.get("bn_var")
    y = x @ layer["linear"]["w"].to(dtype)
    # the forward's blocks: the kernels' sums against the plain ones
    sums_k = devs_k = sums_p = devs_p = None
    if bn:
        sums_k, sums_p = tower.fwd_sums(y, b, w), tower.fwd_sums_plain(y, b, w)
        h = tower._h(y, b)
        wt = torch.ones_like(h[:, :1]) if w is None else w[:, None]
        _sums_close("fwd_sums", sums_k, sums_p, torch.cat([wt * h, wt], 1))
        devs_k, devs_p = tower.fwd_devs(y, b, w, sums_k), tower.fwd_devs_plain(y, b, w, sums_k)
        _sums_close("fwd_devs", devs_k, devs_p, wt * (h - tower._mean(sums_k, n)) ** 2)
    out_a, code_k, run_a = tower.fwd_apply(y, b, gamma, beta, sums_k, devs_k, u, keep, rm, rv)
    assert torch.equal(out_a, out_k) and torch.equal(run_a, run_k)
    out_p, code_p, run_p = tower.fwd_apply_plain(y, b, gamma, beta, sums_p, devs_p, u, keep,
                                                 rm, rv)
    _close("out", out_k, out_p, ULP[dtype])
    flips = tower.unpack_code(code_k, n) != tower.unpack_code(code_p, n)
    if bool(flips.any()):  # only gates within rounding of 0
        z = tower.fwd_apply_plain(y, b, gamma, beta, sums_p, devs_p, None, 1.0, rm, rv)[0]
        assert float(z[flips].abs().max()) <= ABS * float(z.abs().max())
    if bn:
        for k, p in zip(run_k, run_p):
            _close("running", k, p, STATE_TOL, STATE_TOL)
    # the backward's blocks, on the kernels' code, against the plain ones
    gsums = None
    if bn:
        gsums = tower.bwd_sums(dout, y, code_k, b, gamma, beta, sums_k, devs_k, keep)
        _, g, xh, _ = tower._g_xh(dout, y, code_k, b, sums_k, devs_k, gamma, beta, keep)
        _sums_close("bwd_sums", gsums, tower.bwd_sums_plain(dout, y, code_k, b, gamma, beta,
                                                            sums_k, devs_k, keep),
                    torch.cat([g, g * xh], 1))
    dh_k, db_k = tower.bwd_dx(dout, y, code_k, b, gamma, beta, sums_k, devs_k, gsums, w, keep)
    dh_p, db_p = tower.bwd_dx_plain(dout, y, code_k, b, gamma, beta, sums_k, devs_k, gsums, w,
                                    keep)
    _close("dh", dh_k, dh_p, ULP[dtype])
    _sums_close("db", db_k, db_p, dh_p)
    grads_p = [dh_k @ layer["linear"]["w"].to(dtype).t(), (x.t() @ dh_k).float(), db_k]
    if bn:
        grads_p += [gsums[n:], gsums[:n]]
    for name, a, c in zip(("dx", "dW", "db", "dgamma", "dbeta"), g_k, grads_p):
        if name in ("dx", "dW"):  # autograd's GEMMs on the blocks' dh
            assert _norm_gap(a, c) <= 1e-6, name
        else:  # the blocks' bits
            assert torch.equal(a, c), name
    # the kernels and the composition against the exact layer (fp64), the
    # kernels' decisions taken by all three
    relu_k = tower.unpack_code(
        tower.fwd_apply(y, b, gamma, beta, sums_k, devs_k, None, 1.0, rm, rv)[1], n)
    out_c, st_c, g_c, margin = _composed(x, layer, st, u, w, rate, dout, relu_k)
    assert margin <= COMPOSED[dtype]
    out_e, run_e, g_e = _exact(x, layer, st, u, w, rate, dout, code_k)
    got = [("out", out_k, out_c, out_e)]
    if bn:
        got += [(key, k, st_c[key], e) for key, k, e in zip(("bn_mean", "bn_var"), run_k, run_e)]
    got += [(name, a, c, e) for name, a, c, e in zip(("dx", "dW", "db", "dgamma", "dbeta"),
                                                     g_k, g_c, g_e)
            if not (name == "db" and bn)]  # zero up to rounding: noise on every side
    for name, k, c, e in got:
        gap_k, gap_c = _norm_gap(k, e), _norm_gap(c, e)
        assert gap_k <= max(COMPOSED[dtype], gap_c), (name, gap_k, gap_c)


def _exact(x, layer, st, u, w, rate, dout, code):
    """The layer in fp64 on the plain blocks from the same x and W (their
    exact product), ``code`` (the kernels' decisions) taken forward and
    backward: (out, running, gradients of x, W, b, gamma, beta)."""
    f64 = lambda t: None if t is None else t.double()  # noqa: E731
    n = layer["linear"]["b"].shape[0]
    x64, w64 = f64(x), f64(layer["linear"]["w"].to(x.dtype))
    y = x64 @ w64
    b, gamma, beta, wt = (f64(t) for t in (layer["linear"]["b"], layer.get("bn_scale"),
                                            layer.get("bn_bias"), w))
    keep = 1.0 - rate
    on = tower.unpack_code(code, n)
    h = y + b
    sums = devs = gsums = None
    running = torch.empty(0)
    if gamma is not None:
        sums = tower.fwd_sums_plain(y, b, wt)
        devs = tower.fwd_devs_plain(y, b, wt, sums)
        _, _, running = tower.fwd_apply_plain(y, b, gamma, beta, sums, devs, None, 1.0,
                                              f64(st["bn_mean"]), f64(st["bn_var"]))
        _, _, a, c = tower._cols(sums, devs, gamma, beta, n)
        h = a * h + c
    out = torch.where(on, h / keep, 0.0)
    if gamma is not None:
        gsums = tower.bwd_sums_plain(f64(dout), y, code, b, gamma, beta, sums, devs, keep)
    dh, db = tower.bwd_dx_plain(f64(dout), y, code, b, gamma, beta, sums, devs, gsums, wt, keep)
    grads = [dh @ w64.t(), x64.t() @ dh, db]
    if gamma is not None:
        grads += [gsums[n:], gsums[:n]]
    return out, running, grads


WIDTHS = (50, 100, 256, 512)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("bn", [True, False], ids=["bn", "no_bn"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_layer_against_plain_and_composition(n, dtype, bn, rate):
    _check_layer(4133, n, dtype, bn, rate, "mixed" if n in (100, 512) else "none")


@pytest.mark.parametrize("rows", [1, 131072])
@pytest.mark.parametrize("n", [256, 512])
def test_layer_rows(rows, n):
    _check_layer(rows, n, torch.bfloat16, True, 0.2, "none")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_all_weights_zero(dtype):
    _check_layer(517, 100, dtype, True, 0.2, "zero")


@pytest.mark.parametrize("n", WIDTHS)
def test_repeats_bit_for_bit(n):
    x, layer, st, u, w, dout = _case(131072 if n == 512 else 4133, n, torch.bfloat16, True,
                                     0.2, "mixed")
    first = _fused(x, layer, st, u, w, 0.2, dout)
    for _ in range(2):
        again = _fused(x, layer, st, u, w, 0.2, dout)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
        assert all(torch.equal(a, b) for a, b in zip(first[2], again[2]))


@pytest.mark.parametrize("bf16", [True, False])
def test_c_plan(bf16):
    for rows in (1, 63, 64, 4133, 131072, 10 ** 7):
        for n in (1, 50, 100, 256, 512, 1024, 30000):
            assert tower.c_plan(rows, n, bf16) == tower.plan(rows, n, bf16)
    assert tower.c_plan(0, 8, bf16) == tower.plan(0, 8, bf16)
    assert tower.c_plan(1, 0, bf16) is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_no_rows(dtype):
    """A layer on no rows (a data-parallel rank without rows of the batch)
    runs on the kernels, one empty chunk a pass: an empty output, zero
    sums and gradients, the running statistics of zero sums."""
    x, layer, st, u, w, dout = _case(1, 256, dtype, True, 0.2, "mixed")
    x, u, w, dout = x[:0], u[:0], w[:0], dout[:0]
    for fn in tower.BLOCKS:
        fn.launches = 0
    out, running, grads = _fused(x, layer, st, u, w, 0.2, dout)
    torch.cuda.synchronize()
    assert tower.launches() == tower.fwd_launches(True) + tower.bwd_launches(True)
    assert out.shape == (0, 256) and out.dtype == dtype
    y = x @ layer["linear"]["w"].to(dtype)
    b, gamma, beta = layer["linear"]["b"], layer["bn_scale"], layer["bn_bias"]
    sums = tower.fwd_sums_plain(y, b, w)
    devs = tower.fwd_devs_plain(y, b, w, sums)
    want = tower.fwd_apply_plain(y, b, gamma, beta, sums, devs, u, 0.8, st["bn_mean"],
                                 st["bn_var"])[2]
    _close("running", running, want, STATE_TOL, STATE_TOL)
    dx, dw, db, dgamma, dbeta = grads
    assert dx.shape == x.shape
    for name, g in (("dW", dw), ("db", db), ("dgamma", dgamma), ("dbeta", dbeta)):
        assert not bool(g.any()), name


def test_launch_counters_in_a_step():
    """mlp.apply in train mode on a card: every hidden layer on the blocks,
    fwd_launches + bwd_launches a layer, and no composition left."""
    gen = torch.Generator().manual_seed(3)
    params, state = mlp.init(gen, 64, [512, 256], out_dim=1)
    params = {"layers": [{k: ({kk: vv.cuda() for kk, vv in v.items()} if isinstance(v, dict)
                              else v.cuda()) for k, v in lay.items()}
                         for lay in params["layers"]],
              "out": {k: v.cuda() for k, v in params["out"].items()}}
    state = {"layers": [{k: v.cuda() for k, v in st.items()} for st in state["layers"]]}
    for lay in params["layers"]:
        for v in [*lay["linear"].values(), lay["bn_scale"], lay["bn_bias"]]:
            v.requires_grad_()
    x = torch.randn(4096, 64, device="cuda").to(torch.bfloat16).requires_grad_()
    dgen = torch.Generator(device="cuda").manual_seed(5)
    for fn in tower.BLOCKS:
        fn.launches = 0
    for step in range(1, 3):
        out, new_state = mlp.apply(params, state, x, train=True, dropout_rate=0.2,
                                   generator=dgen)
        out.float().sum().backward()
        torch.cuda.synchronize()
        per_layer = tower.fwd_launches(True) + tower.bwd_launches(True)
        assert tower.launches() == step * 2 * per_layer
        assert [s["bn_mean"].shape[0] for s in new_state["layers"]] == [512, 256]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_one_rank_group_bit_for_bit():
    """A data-parallel step over a one-rank gloo group takes the
    all-reduces between the blocks and gives the one-process step's bits."""
    import torch.distributed as dist

    os.environ.setdefault("MASTER_ADDR", "localhost")
    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
    try:
        group = dist.new_group([0])
        x, layer, st, u, w, dout = _case(4133, 256, torch.bfloat16, True, 0.2, "mixed")
        want = _fused(x, layer, st, u, w, 0.2, dout)
        calls = data_parallel.stats["calls"]
        leaves = _leaves(x, layer)
        lay = _rebuild(layer, leaves)
        y = leaves[0] @ lay["linear"]["w"].to(x.dtype)
        with data_parallel.step_slice(data_parallel.DataSlice(group, 1, 0, x.shape[0])):
            out, running = tower.TowerLayer.apply(
                y, lay["linear"]["b"], lay["bn_scale"], lay["bn_bias"], u, w, st["bn_mean"],
                st["bn_var"], 0.8, group)
        grads = torch.autograd.grad(out, leaves, dout)
        assert data_parallel.stats["calls"] - calls == 3  # sums, devs, the backward's sums
        assert torch.equal(out, want[0]) and torch.equal(running, want[1])
        assert all(torch.equal(a, b) for a, b in zip(grads, want[2]))
    finally:
        if owned:
            dist.destroy_process_group()
