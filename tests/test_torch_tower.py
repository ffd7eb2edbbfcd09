"""The tower kernels' plain versions (ops/cuda/tower.py) on the CPU, no JAX.

``TowerLayer`` on CPU tensors runs the five blocks' plain versions: fp32
statistics (fp64 for fp64 tensors), the closed-form BatchNorm backward and
the bit-packed code. In float64 it must equal autograd through
``ops/mlp.py``'s composition (the bias add, ``_batch_norm``, ReLU,
dropout's select) to rounding (1e-12 of the largest magnitude): outputs,
running statistics and the gradients of y, b, gamma and beta, with
BatchNorm and without, plain, weighted and all-zero weights, dropout on and
off, at widths that are not a multiple of the kernels' 8 or 32 columns, and
at one row; at no rows, empty and zero. Beside them: the code's packing at ragged widths, ``plan``, the
launch counts, and ``mlp.apply`` keeping the composition on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ctr_recommendation_tpu_torch.ops import mlp
from ctr_recommendation_tpu_torch.ops.cuda import tower

torch.set_num_threads(2)
F64_TOL = 1e-12


def _case(rows, n, bn, weights, rate, seed=0):
    g = torch.Generator().manual_seed(seed + 7 * n + rows)
    f64 = dict(generator=g, dtype=torch.float64)
    y = (1.5 * torch.randn(rows, n, **f64) + 0.3).requires_grad_()
    layer = {"linear": {"b": (0.5 * torch.randn(n, **f64)).requires_grad_()}}
    st = {}
    if bn:
        layer["bn_scale"] = (1 + 0.2 * torch.randn(n, **f64)).requires_grad_()
        layer["bn_bias"] = (0.2 * torch.randn(n, **f64)).requires_grad_()
        st = {"bn_mean": 0.1 * torch.randn(n, **f64), "bn_var": 0.5 + torch.rand(n, **f64)}
    w = {"none": None, "mixed": (torch.rand(rows, generator=g) > 0.3).double(),
         "zero": torch.zeros(rows, dtype=torch.float64)}[weights]
    u = torch.rand(rows, n, **f64) if rate > 0 else None
    return y, layer, st, w, u, torch.randn(rows, n, **f64)


def _composed(y, layer, st, w, u, rate):
    h = y + layer["linear"]["b"]
    new_st = st
    if "bn_scale" in layer:
        h, new_st = mlp._batch_norm(layer, st, h, True, w)
    h = torch.relu(h)
    if u is not None:
        h = torch.where(u < 1.0 - rate, h / (1.0 - rate), 0.0)
    return h, new_st


def _leaves(y, layer):
    return [y, layer["linear"]["b"], *(layer[k] for k in ("bn_scale", "bn_bias") if k in layer)]


def _check(rows, n, bn, weights, rate):
    y, layer, st, w, u, dout = _case(rows, n, bn, weights, rate)
    want, want_st = _composed(y, layer, st, w, u, rate)
    want_g = torch.autograd.grad(want, _leaves(y, layer), dout)
    got, running = tower.TowerLayer.apply(
        y, layer["linear"]["b"], layer.get("bn_scale"), layer.get("bn_bias"), u, w,
        st.get("bn_mean"), st.get("bn_var"), 1.0 - rate, None)
    got_g = torch.autograd.grad(got, _leaves(y, layer), dout)
    got, want = got.detach(), want.detach()
    scale = lambda t: F64_TOL * max(1.0, float(t.abs().max()))  # noqa: E731
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) <= scale(want)
    if bn:
        for k, key in zip(running, ("bn_mean", "bn_var")):
            assert float((k - want_st[key]).abs().max()) <= scale(want_st[key])
    else:
        assert running.numel() == 0
    for name, a, b in zip(("dy", "db", "dgamma", "dbeta"), got_g, want_g):
        assert float((a - b).abs().max()) <= scale(b), name


@pytest.mark.parametrize("bn", [True, False], ids=["bn", "no_bn"])
@pytest.mark.parametrize("weights", ["none", "mixed", "zero"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_layer_against_the_composition_f64(bn, weights, rate):
    _check(37, 50, bn, weights, rate)


@pytest.mark.parametrize("rows, n", [(1, 9), (1, 256), (203, 100), (64, 257)])
def test_plain_layer_rows_and_widths_f64(rows, n):
    _check(rows, n, True, "none", 0.2)
    _check(rows, n, True, "mixed", 0.0)


@pytest.mark.parametrize("bn", [True, False], ids=["bn", "no_bn"])
@pytest.mark.parametrize("weights", ["none", "mixed"])
def test_plain_layer_no_rows(bn, weights):
    """No rows (a data-parallel rank without rows of the batch): an empty
    output and code, zero parameter gradients, and the running statistics
    the composition takes from zero sums."""
    y, layer, st, w, u, dout = _case(0, 50, bn, weights, 0.2)
    want, want_st = _composed(y, layer, st, w, u, 0.2)
    want_g = torch.autograd.grad(want, _leaves(y, layer), dout, allow_unused=True)
    got, running = tower.TowerLayer.apply(
        y, layer["linear"]["b"], layer.get("bn_scale"), layer.get("bn_bias"), u, w,
        st.get("bn_mean"), st.get("bn_var"), 0.8, None)
    got_g = torch.autograd.grad(got, _leaves(y, layer), dout)
    assert got.shape == (0, 50) and tower.pack_code(got > 0).shape == (0, tower.code_bytes(50))
    assert tower.unpack_code(tower.pack_code(got > 0), 50).shape == (0, 50)
    if bn:
        for k, key in zip(running, ("bn_mean", "bn_var")):
            assert float((k - want_st[key]).abs().max()) <= F64_TOL
    assert got_g[0].shape == (0, 50)
    for name, a, b in zip(("db", "dgamma", "dbeta"), got_g[1:], want_g[1:]):
        assert not bool(a.any()) and (b is None or not bool(b.any())), name


@pytest.mark.parametrize("n", [1, 7, 8, 9, 50, 100, 257])
def test_code_packing_at_ragged_widths(n):
    g = torch.Generator().manual_seed(n)
    bits = torch.rand(11, n, generator=g) > 0.5
    code = tower.pack_code(bits)
    assert code.dtype == torch.uint8 and code.shape == (11, tower.code_bytes(n))
    want = np.packbits(bits.numpy(), axis=1, bitorder="little")  # bit k of byte m: 8 m + k
    np.testing.assert_array_equal(code.numpy(), want)
    assert torch.equal(tower.unpack_code(code, n), bits)


@pytest.mark.parametrize("bf16", [True, False])
def test_plan_covers_the_rows(bf16):
    for rows in (1, 63, 64, 65, 4133, 131072, 10 ** 7):
        for n in (1, 50, 100, 256, 512, 1024):
            p = tower.plan(rows, n, bf16)
            assert p.vec == ((8 if bf16 else 4) if n % (8 if bf16 else 4) == 0 else 1)
            assert p.tiles * 32 * p.vec >= n > (p.tiles - 1) * 32 * p.vec
            assert p.chunk_rows % tower.WARPS == 0 and p.chunk_rows >= tower.MIN_CHUNK
            assert p.chunks * p.chunk_rows >= rows > (p.chunks - 1) * p.chunk_rows
            assert p.tiles * p.chunks <= tower.TARGET_BLOCKS + p.tiles
    # the mm cell's widths: a few hundred blocks a pass, 16-byte vectors
    assert tower.plan(131072, 512, True) == tower.Plan(8, 2, 504, 261)
    assert tower.plan(131072, 256, True) == tower.Plan(8, 1, 256, 512)
    # no rows (a data-parallel rank without rows of the batch): one empty chunk
    assert tower.plan(0, 512, bf16) == tower.Plan(8 if bf16 else 4, 2 if bf16 else 4, 64, 1)
    for rows, n in ((-1, 8), (1, 0)):
        with pytest.raises(ValueError):
            tower.plan(rows, n, bf16)


def test_launch_counts_and_constants():
    assert (tower.fwd_launches(True), tower.bwd_launches(True)) == (5, 4)
    assert (tower.fwd_launches(False), tower.bwd_launches(False)) == (1, 2)
    assert (tower.EPS, tower.MOMENTUM) == (mlp.BN_EPS, mlp.BN_MOMENTUM)


def test_apply_keeps_the_composition_on_the_cpu():
    """mlp.apply on CPU tensors in train mode: no block launches, the same
    result as the composition, and on_kernels false."""
    params, state = mlp.init(torch.Generator().manual_seed(0), 12, [16, 8])
    x = torch.randn(10, 12, generator=torch.Generator().manual_seed(1))
    assert not mlp.on_kernels(x, True) and not mlp.on_kernels(x, False)
    before = tower.launches()
    out, _ = mlp.apply(params, state, x, train=True, dropout_rate=0.2,
                       generator=torch.Generator().manual_seed(2))
    assert tower.launches() == before and out.shape == (10, 1)
    with pytest.raises(ValueError, match="generator"):
        mlp.apply(params, state, x, train=True, dropout_rate=0.2)


def test_stats_one_interface():
    """mlp._stats: the plain branch is the weighted one with unit weights,
    and matches the batch's mean and biased / unbiased variance."""
    h = torch.randn(33, 5, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    mean, var, unbiased = mlp._stats(h, None)
    wm, wv, wu = mlp._stats(h, torch.ones(33, dtype=torch.float64))
    assert torch.equal(mean, wm) and torch.equal(var, wv) and torch.equal(unbiased, wu)
    torch.testing.assert_close(mean, h.mean(0), rtol=1e-14, atol=1e-14)
    torch.testing.assert_close(var, h.var(0, unbiased=False), rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(unbiased, h.var(0), rtol=1e-12, atol=1e-14)
    w = torch.zeros(33, dtype=torch.float64)
    w[[2, 5, 30]] = 1
    mean, var, unbiased = mlp._stats(h, w)
    torch.testing.assert_close(mean, h[[2, 5, 30]].mean(0), rtol=1e-14, atol=1e-14)
    torch.testing.assert_close(var, h[[2, 5, 30]].var(0, unbiased=False), rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(unbiased, h[[2, 5, 30]].var(0), rtol=1e-12, atol=1e-14)
