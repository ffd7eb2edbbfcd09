"""The SASRec encoder at any batch (CPU): a call cut into chunks of whole
rows, each within MAX_TOKENS tokens and WORKSPACE_BUDGET bytes of workspace,
as the JAX kernel's grid walks the batch in blocks of ``block_b`` rows.

``plan_chunks`` is a pure function of the shapes; the wrappers run each
chunk at its own token base, and the backward adds the chunks' weight
gradients in chunk order. The kernels cannot run without a card; the
wrappers take the same plan over their plain versions on CPU tensors, which
is what these tests drive, with the budget made small here (and only here)
so that a few histories already cut into several chunks. chip_smoke.py's
phase 7e (c) holds the chunked kernels on the card (``[chunked ...]``).

Tolerances, each with its reason:
- the chunked forward and dx against the unchunked call: bit for bit (each
  row's arithmetic is its own; the chunk's token base keys the same
  dropout masks);
- the chunked weight gradients against the unchunked call's: rtol 1e-6,
  atol 1e-6 of the leaf's largest magnitude (the same fp32 terms, the
  chunks' sums added in another order);
- against the JAX kernel in interpret mode and ``jax.vjp`` of its
  ``_fused``: the bars of tests/test_torch_encoder_long.py (forward fp32
  3e-6, bf16 one bf16 ulp of the largest magnitude; fp32 gradients rtol
  1e-5, atol 1e-6 of the leaf's largest; bf16 gradients at L = 2 at most
  half as far from JAX's as from the port's own fp32 backward, a rounding
  cascade through two layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctr_recommendation_tpu.ops.pallas import sasrec_encoder as jax_enc
from ctr_recommendation_tpu_torch.ops.cuda import encoder_blocks as eb
from ctr_recommendation_tpu_torch.ops.cuda import sasrec_encoder as enc
from tests.test_torch_sasrec import DTYPES, _encoder_case, bf16_ulp, to_pt

torch.set_num_threads(2)

B, S, E, H, L = 37, 20, 32, 2, 2  # the chunked calls' shape
CHUNK_ROWS = 14  # rows a chunk under the forced budget: 14, 14, 9
TOKEN0 = 2**32 - 300  # a token base whose second chunk wraps past 2^32

# (B, S, E, H, L, dtype, direction) of the encoder calls chip_smoke.py made
# before calls were cut into chunks, the largest of each family: phase 2's
# checks, phase 3's and 7e's timing, 7e's cases past 32 keys, the trained
# and served sasrec_fibinet at max_len 20, 50 and 200 (ML-1M), sasrec_emb_256,
# and 7e (c)'s head of 512 (its eval forward and the serve, bf16)
F32, BF16 = torch.float32, torch.bfloat16
SMOKE_CALLS = [
    (8192 + 37, 20, 128, 2, 1, F32, "fwd"), (4096 + 37, 20, 64, 4, 2, F32, "fwd"),
    (8192 + 37, 20, 256, 2, 1, F32, "fwd"), (4096 + 37, 20, 256, 4, 2, F32, "fwd"),
    (4096 + 37, 20, 128, 2, 1, F32, "bwd"), (4096 + 37, 20, 64, 4, 2, F32, "bwd"),
    (4096 + 37, 20, 256, 2, 1, F32, "bwd"),
    (8192, 20, 128, 2, 1, BF16, "fwd"), (4096, 20, 128, 2, 1, BF16, "bwd"),
    (8192, 20, 256, 2, 1, BF16, "fwd"), (4096, 20, 256, 2, 1, BF16, "bwd"),
    (8192, 50, 128, 2, 1, BF16, "fwd"), (4096, 50, 128, 2, 1, BF16, "bwd"),
    (8192, 200, 128, 2, 1, BF16, "fwd"), (4096, 200, 128, 2, 1, BF16, "bwd"),
    (8192, 200, 50, 1, 2, BF16, "fwd"), (4096, 200, 50, 1, 2, BF16, "bwd"),
    (4096 + 37, 64, 256, 2, 1, F32, "bwd"), (4096 + 37, 100, 64, 2, 2, F32, "bwd"),
    (1024 + 37, 200, 128, 2, 1, F32, "bwd"), (1024 + 37, 512, 64, 2, 1, F32, "bwd"),
    (1024 + 37, 50, 288, 1, 1, F32, "bwd"), (1024 + 37, 200, 50, 2, 2, F32, "bwd"),
    (16384, 50, 512, 1, 1, BF16, "fwd"), (4096, 50, 512, 1, 1, BF16, "bwd"),
]

# (B, S, E, H, L, dtype, direction) the planner is held on: SMOKE_CALLS'
# shapes and chip_smoke.py's chunked ones, a call one token past MAX_TOKENS
# (19 x 441,499), a history a chunk, histories past shared memory and
# padded widths
PLAN_CASES = SMOKE_CALLS + [
    (45_000, 200, 128, 2, 1, BF16, "fwd"), (24_576, 200, 256, 2, 1, BF16, "bwd"),
    (65_536, 200, 50, 1, 2, BF16, "fwd"), (441_499, 19, 32, 2, 1, BF16, "fwd"),
    (441_499, 19, 32, 2, 1, BF16, "bwd"), (3, 2_000_000, 32, 1, 1, F32, "fwd"),
    (100_000, 512, 1024, 2, 3, F32, "bwd"), (1, 1, 10, 1, 1, F32, "bwd"),
    (0, 20, 128, 2, 1, BF16, "fwd"),
]


def _workspace(b, s, e, heads, layers, dtype, direction):
    bf16 = dtype == torch.bfloat16
    if direction == "fwd":
        return enc.fwd_workspace(b, s, e, heads, bf16)
    return enc.bwd_workspace(b, s, e, heads, layers, bf16)


@pytest.fixture
def small_budget(monkeypatch):
    """WORKSPACE_BUDGET cut to CHUNK_ROWS rows of the chunked calls' shape,
    one direction at a time (the constant is not a knob of the port)."""
    def force(dtype, direction):
        monkeypatch.setattr(enc, "WORKSPACE_BUDGET",
                            _workspace(CHUNK_ROWS, S, E, H, L, dtype, direction))
        plan = enc.plan_chunks(B, S, E, H, L, dtype, direction)
        assert len(plan) >= 3 and len({r1 - r0 for r0, r1 in plan}) > 1, plan
        return plan
    return force


# ------------------------------------------------------------ the planner

@pytest.mark.parametrize("b, s, e, heads, layers, dtype, direction", PLAN_CASES)
def test_the_plan_covers_the_batch_within_both_bounds(b, s, e, heads, layers, dtype, direction):
    """Chunks of at least one row cover [0, B) in order, each within
    MAX_TOKENS tokens and WORKSPACE_BUDGET bytes, as many rows a chunk as
    both allow (the last ragged); the same shapes give the same plan."""
    plan = enc.plan_chunks(b, s, e, heads, layers, dtype, direction)
    assert plan == enc.plan_chunks(b, s, e, heads, layers, dtype, direction)
    assert [r0 for r0, _ in plan] == [0] * bool(plan) + [r1 for _, r1 in plan[:-1]]
    assert (plan[-1][1] if plan else 0) == b
    rows = plan[0][1] if plan else 0
    for r0, r1 in plan:
        assert r1 > r0 and (r1 - r0 == rows or r1 == b)
        if s <= enc.MAX_TOKENS:
            assert (r1 - r0) * s <= enc.MAX_TOKENS
        assert _workspace(r1 - r0, s, e, heads, layers, dtype, direction) <= enc.WORKSPACE_BUDGET
    if len(plan) > 1:  # one row more would break a bound
        more = rows + 1
        assert (more * s > enc.MAX_TOKENS or _workspace(more, s, e, heads, layers, dtype, direction)
                > enc.WORKSPACE_BUDGET)
    per = enc.fwd_launches(layers) if direction == "fwd" else enc.bwd_launches(layers)
    assert enc.call_launches(b, s, e, heads, layers, dtype, direction) == per * len(plan)


@pytest.mark.parametrize("b, s, e, heads, layers, dtype, direction", SMOKE_CALLS)
def test_the_calls_chip_smoke_made_before_stay_one_chunk(b, s, e, heads, layers, dtype, direction):
    """WORKSPACE_BUDGET leaves every call chip_smoke.py made before calls
    were chunked one chunk: the whole-call launch sequence, unchanged."""
    assert enc.plan_chunks(b, s, e, heads, layers, dtype, direction) == ((0, b),)
    assert _workspace(b, s, e, heads, layers, dtype, direction) <= enc.WORKSPACE_BUDGET


def test_one_token_past_max_tokens_is_taken_in_two_chunks():
    """B*S = MAX_TOKENS + 1 (19 x 441,499 histories): no envelope refusal,
    and both directions plan at least two chunks, each within MAX_TOKENS
    and the budget; the planner alone, nothing that size allocated."""
    b, s, e, heads = 441_499, 19, 32, 2
    assert b * s == enc.MAX_TOKENS + 1
    enc.check_envelope(s, e, heads, 1)
    for direction in ("fwd", "bwd"):
        plan = enc.plan_chunks(b, s, e, heads, 1, torch.bfloat16, direction)
        assert len(plan) >= 2 and plan[-1][1] == b
        assert all((r1 - r0) * s <= enc.MAX_TOKENS for r0, r1 in plan)
        assert all(_workspace(r1 - r0, s, e, heads, 1, torch.bfloat16, direction)
                   <= enc.WORKSPACE_BUDGET for r0, r1 in plan)
    assert enc.plan_chunks(b, s, e, heads, 1, torch.bfloat16, "fwd") == ((0, b - 1), (b - 1, b))


def test_the_workspace_mirror_matches_the_per_token_figures():
    """fwd_workspace / bwd_workspace at E = 128, bf16 (the module
    docstring's figures, the C carve's pieces): the forward's 3,584 bytes a
    token; the backward's staged layer (S = 20) 4,520 bytes a token, its
    streamed one (S = 200) 4,888, and 4,864 bytes a token besides; pieces
    256-byte aligned; the weight-gradient partials of a layer as split."""
    assert enc.fwd_workspace(4096, 20, 128, 2, True) == 4096 * 20 * 3584
    assert enc.fwd_workspace(1, 1, 32, 1, True) == 1536  # 128, 64, 384, 64, 256 bytes aligned
    for s, layer in ((20, 4520), (200, 4888)):
        n = 4096 * s
        part = enc._partial_floats(n, 128) * 4
        assert enc.bwd_workspace(4096, s, 128, 2, 1, True) == n * (layer + 4864) + part
        assert enc.bwd_workspace(4096, s, 128, 2, 2, True) == n * (2 * layer + 4864) + part
    # a split sum aims at 264 blocks, one chunk per 64 tokens at most: at
    # 264 x 64 tokens qkv_w's 3 tiles take 88 chunks, proj_w's one 264,
    # ffn1_w's and ffn2_w's 4 each 66, the vectors (one column block) 264
    assert enc._partial_floats(64, 128) == 128 * 128 * (3 + 1 + 4 + 4) + 13 * 128
    assert enc._partial_floats(264 * 64, 128) == 128 * 128 * (3 * 88 + 264 + 4 * 66 + 4 * 66) \
        + 264 * 13 * 128


def test_the_envelope_refuses_only_the_history():
    """check_envelope bounds S (MAX_STREAM_S), not B*S; its message says why."""
    enc.check_envelope(enc.MAX_STREAM_S, 32, 1, 1)
    with pytest.raises(ValueError, match="envelope") as err:
        enc.check_envelope(enc.MAX_STREAM_S + 1, 32, 1, 1)
    assert "B*S" not in str(err.value) and str(enc.MAX_STREAM_S) in str(err.value)
    with pytest.raises(ValueError, match="direction"):
        enc.plan_chunks(4, 20, 32, 2, 1, torch.float32, "both")


# ------------------------------------------------------------ the chunk loop on the plain versions

def _inputs(dtype, seed=0):
    params, x, ids = _encoder_case(L, B, seed=seed, e=E, s=S, heads=H)
    pp = to_pt(params)
    xm, am, pad = enc.encoder_inputs(pp, torch.from_numpy(x).to(dtype), torch.from_numpy(ids))
    g = np.random.default_rng(seed + 1).standard_normal((B, S, E)).astype(np.float32)
    g = torch.from_numpy(g * ~pad.numpy()[..., None]).to(dtype)
    return params, pp, xm, am, g, enc.stack_weights(pp, dtype)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_chunked_forward_is_the_whole_call_bit_for_bit(small_budget, dtype, rate):
    """encode_fwd in >= 3 uneven chunks, a token base past 2^32 on the way:
    the unchunked plain call's output bit for bit, and the chunks' dropout
    masks (at each chunk's token base) the whole call's rows."""
    td = DTYPES[dtype][1]
    _, _, xm, am, _, ws = _inputs(td)
    seed = torch.tensor([23], dtype=torch.int64)
    kw = dict(num_heads=H, seed=seed, rate=rate, token0=TOKEN0)
    want = enc.encode_fwd_plain(xm, am, *ws, **kw)
    plan = small_budget(td, "fwd")
    launches = enc.encode_fwd.launches
    got = enc.encode_fwd(xm, am, *ws, **kw)
    assert enc.encode_fwd.launches == launches  # CPU tensors: the plain versions
    assert got.dtype == td and torch.equal(got, want)
    whole = eb.dropout_mask(seed, B * S, E, 1, 1, 0.1, TOKEN0)
    parts = [eb.dropout_mask(seed, (r1 - r0) * S, E, 1, 1, 0.1, TOKEN0 + r0 * S)
             for r0, r1 in plan]
    assert torch.equal(torch.cat(parts), whole)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_chunked_backward_matches_the_whole_call(small_budget, dtype, rate):
    """encode_bwd in >= 3 uneven chunks: dx bit for bit the unchunked plain
    call's, the 12 weight gradients (the chunks' sums in chunk order)
    within 1e-6 of its; the same call twice bit for bit."""
    td = DTYPES[dtype][1]
    _, _, xm, am, g, ws = _inputs(td, seed=4)
    kw = dict(num_heads=H, seed=torch.tensor([31], dtype=torch.int64), rate=rate,
              token0=TOKEN0)
    want = enc.encode_bwd_plain(g, xm, am, *ws, **kw)
    small_budget(td, "bwd")
    got = enc.encode_bwd(g, xm, am, *ws, **kw)
    again = enc.encode_bwd(g, xm, am, *ws, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert got[0].dtype == td and torch.equal(got[0], want[0])
    for name, a, w in zip(enc.WEIGHT_NAMES, got[1:], want[1:]):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6 * w.abs().max().item(), err_msg=name)


def test_fused_encode_autograd_takes_the_chunks(small_budget):
    """fused_encode's autograd Function in chunks both ways: the forward
    and x's gradient bit for bit those of the whole call (fp32)."""
    _, pp, xm, _, g, _ = _inputs(torch.float32, seed=9)
    _, x, ids = _encoder_case(L, B, seed=9, e=E, s=S, heads=H)
    ids_t = torch.from_numpy(ids)

    def run():
        xt = torch.from_numpy(x).requires_grad_()
        out = enc.fused_encode(pp, xt, ids_t, num_heads=H)
        (dx,) = torch.autograd.grad(out, xt, g)
        return out.detach(), dx

    want = run()
    small_budget(torch.float32, "fwd")
    got_f = run()[0]
    small_budget(torch.float32, "bwd")
    got_b = run()[1]
    assert torch.equal(got_f, want[0]) and torch.equal(got_b, want[1])


# ------------------------------------------------------------ against the JAX kernel

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_chunked_forward_matches_the_jax_kernel(small_budget, dtype):
    """fused_encode in chunks at B = 37 against the JAX fused_encode, whose
    grid walks the batch in blocks of 8 rows, in interpret mode."""
    jd, td = DTYPES[dtype]
    params, x, ids = _encoder_case(L, B, seed=2, e=E, s=S, heads=H)
    want = np.asarray(jax_enc.fused_encode(params, jnp.asarray(x).astype(jd), jnp.asarray(ids),
                                           num_heads=H, block_b=8), np.float32)
    small_budget(td, "fwd")
    got = enc.fused_encode(to_pt(params), torch.from_numpy(x).to(td), torch.from_numpy(ids),
                           num_heads=H)
    assert got.dtype == td and got.shape == (B, S, E) and not got[0].any()
    atol = 3e-6 if dtype == "float32" else bf16_ulp(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_chunked_backward_matches_the_jax_vjp(small_budget, dtype):
    """encode_bwd in chunks at B = 37: dx and the 12 weight gradients
    against jax.vjp of the JAX kernel's _fused (blocks of 8 rows)."""
    jd, td = DTYPES[dtype]
    params, pp, xm, am, g, ws = _inputs(td, seed=6)

    def f(xx, w):
        return jax_enc._fused(xx, jnp.asarray(am.numpy()), jnp.zeros((1,), jnp.float32), w,
                              S, E, H, L, 0.0, True, 8)

    jx = jnp.asarray(xm.float().numpy().reshape(B, S * E)).astype(jd)
    w32 = enc.stack_weights(pp, torch.float32)
    _, vjp = jax.vjp(f, jx, tuple(jnp.asarray(w.numpy()) for w in w32))
    dx, dws = vjp(jnp.asarray(g.float().numpy().reshape(B, S * E)).astype(jd))
    want = [np.asarray(dx, np.float32).reshape(B, S, E)] + [np.asarray(t) for t in dws]
    small_budget(td, "bwd")
    got = enc.encode_bwd(g, xm, am, *ws, num_heads=H)
    if dtype == "bfloat16":  # the rounding cascade through two layers
        f32 = enc.encode_bwd(g.float(), xm.float(), am, *w32, num_heads=H)
        for name, a, w, r in zip(("dx",) + enc.WEIGHT_NAMES, got, want, f32):
            a = a.float().numpy()
            assert np.isfinite(a).all(), name
            assert np.linalg.norm(a - w) <= 0.5 * np.linalg.norm(a - r.numpy()), name
        return
    for name, a, w in zip(("dx",) + enc.WEIGHT_NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(w).max()), err_msg=name)
