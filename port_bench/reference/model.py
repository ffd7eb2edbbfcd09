"""The plain reference of the two configurations: MM-FiBiNET and
SASRec-FiBiNET on MicroLens-shaped rows, written from their equations in
plain PyTorch, float32 throughout (TF32 off), with no kernel, no cache and
no batching trick. It imports nothing of the port and nothing of JAX.

The model (the reference's model_fibinet.py:91-199, and SASRec, Kang &
McAuley, ICDM 2018, for the history of ``sasrec_fibinet``), fields in the
order [user, likes_level, views_level, item_id, item_emb_d128, item_seq]:

* user: a zero field (the reference stacks zeros for it);
* likes_level, views_level: rows of one shared table; item_id: a row of the
  item table;
* item_emb_d128: the item's frozen 128-d vector, joined by item id (zero
  past the item matrix), through Linear -> LayerNorm (eps 1e-5) -> ReLU;
* item_seq: ``mean``: the masked mean of the history's item rows (pad id 0
  left out, an empty history gives zeros); ``attention``: the history's
  item rows plus learned positions, pad steps zeroed, through L pre-norm
  blocks (LayerNorm eps 1e-6; one-or-more-head self-attention whose keys at
  pad steps are masked with -1e9, its projection, dropout, the residual;
  LayerNorm, FFN E -> 4E -> E with ReLU, dropout, the residual), pad steps
  zeroed, then pooled by the candidate item: softmax over real steps of
  (item W_q + b_q) . h_s / sqrt(E), zeros for an empty history;
* SENet: a = sigmoid(W2 relu(W1 mean_E(x) + b1) + b2), x_f <- a_f x_f;
* bilinear "all": p_ij = x_i * (x_j W) for i < j in row-major order;
* the tower over [x.flat | p.flat]: Linear -> BatchNorm (train: the batch's
  mean and biased variance; eval: the running ones; eps 1e-5) -> ReLU ->
  dropout, twice, then a Linear to one logit.

``rnd`` rounds the tensors the configuration computes in its compute dtype
(bf16 here); the identity gives the float32 reference, another rounding a
control in a lower precision. Dropout masks come from the caller's
generator (the tower) and seed (the encoder), drawn as the port draws them
(``philox``).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from reference.philox import encoder_keep

NEG_INF = -1e9
TRUNK_LN_EPS = 1e-5
ENCODER_LN_EPS = 1e-6
BN_EPS = 1e-5


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _ln(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _linear(p: dict, x: torch.Tensor, rnd: Callable) -> torch.Tensor:
    return rnd(rnd(x) @ rnd(p["w"]) + p["b"])


def _encode(p: dict, x: torch.Tensor, pad: torch.Tensor, sizes: dict, rnd: Callable,
            drop: tuple | None) -> torch.Tensor:
    """The SASRec blocks over x (B, S, E), pad (B, S) bool."""
    b, s, e = x.shape
    heads = sizes["attn_num_heads"]
    d = e // heads
    h = x
    key_mask = torch.zeros(pad.shape, dtype=h.dtype, device=h.device).masked_fill(pad, NEG_INF)

    def dropout(a, layer, branch):
        if drop is None:
            return a
        seed, rate = drop
        keep = encoder_keep(seed, b * s, e, layer, branch, rate).reshape(b, s, e)
        return torch.where(keep, a * (1.0 / (1.0 - rate)), torch.zeros((), device=a.device))

    for li, blk in enumerate(p["blocks"]):
        hn = _ln(h, blk["ln1_scale"], blk["ln1_bias"], ENCODER_LN_EPS)
        qkv = rnd(hn) @ rnd(blk["qkv"]["w"]) + blk["qkv"]["b"]
        q, k, v = (t.reshape(b, s, heads, d).transpose(1, 2) for t in qkv.split(e, -1))
        logits = q @ k.transpose(-1, -2) / math.sqrt(d) + key_mask[:, None, None, :]
        ao = (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(b, s, e)
        a = rnd(ao) @ rnd(blk["proj"]["w"]) + blk["proj"]["b"]
        h = h + dropout(a, li, 0)
        hn = _ln(h, blk["ln2_scale"], blk["ln2_bias"], ENCODER_LN_EPS)
        f1 = rnd(torch.relu(rnd(hn) @ rnd(blk["ffn1"]["w"]) + blk["ffn1"]["b"]))
        f = f1 @ rnd(blk["ffn2"]["w"]) + blk["ffn2"]["b"]
        h = h + dropout(f, li, 1)
    return rnd(torch.where(pad[..., None], torch.zeros((), device=h.device), h))


def _history(w: dict, batch: dict, item_field: torch.Tensor, sizes: dict, rnd: Callable,
             drop: tuple | None) -> torch.Tensor:
    table = w["trunk"]["tables"]["item_id"]
    seq = batch["item_seq"].long()
    pad = seq == 0
    emb = rnd(table[seq])
    if sizes["seq_pooling"] == "mean":
        real = (~pad).float()
        pooled = rnd((emb * real[..., None]).sum(1)) / real.sum(1, keepdim=True).clamp(min=1.0)
        return rnd(pooled)
    p = w["trunk"]["attn"]["item_seq"]
    s = seq.shape[1]
    x = rnd(emb + rnd(p["pos_emb"][:s]))
    x = torch.where(pad[..., None], torch.zeros((), device=x.device), x)
    enc = _encode(p, x, pad, sizes, rnd, drop)
    e = enc.shape[-1]
    q = _linear(p["pool_q"], item_field, rnd)
    logits = rnd(rnd(torch.einsum("be,bse->bs", q, enc)) / math.sqrt(e)).masked_fill(pad, NEG_INF)
    pooled = rnd(torch.einsum("bs,bse->be", rnd(torch.softmax(logits, -1)), enc))
    return torch.where((~pad).any(-1, keepdim=True), pooled, torch.zeros((), device=enc.device))


def fields(w: dict, batch: dict, item_emb: torch.Tensor, sizes: dict, rnd: Callable = identity,
           drop: tuple | None = None) -> torch.Tensor:
    """The field stack (B, F, E)."""
    tables = w["trunk"]["tables"]
    item = batch["item_id"].long()
    b = item.shape[0]
    dense = w["trunk"]["dense"]["item_emb_d128"]
    inside = (item >= 0) & (item < item_emb.shape[0])
    mm = torch.where(inside[:, None], item_emb[item.clamp(0, item_emb.shape[0] - 1)],
                     torch.zeros((), device=item_emb.device))
    mm_field = rnd(torch.relu(_ln(mm @ dense["proj"]["w"] + dense["proj"]["b"],
                                  dense["ln_scale"], dense["ln_bias"], TRUNK_LN_EPS)))
    item_field = rnd(tables["item_id"][item])
    out = [
        torch.zeros((b, sizes["embedding_dim"]), device=item.device),
        rnd(tables["likes_level"][batch["likes_level"].long()]),
        rnd(tables["likes_level"][batch["views_level"].long()]),
        item_field,
        mm_field,
        _history(w, batch, item_field, sizes, rnd, drop),
    ]
    return torch.stack(out, dim=1)


def interaction(w: dict, x: torch.Tensor, rnd: Callable = identity) -> torch.Tensor:
    """SENet + bilinear "all" + concat: (B, F, E) -> (B, (F + F(F-1)/2) E)."""
    b, f, _ = x.shape
    se = w["senet"]
    a = torch.relu(x.mean(-1) @ se["fc1"]["w"] + se["fc1"]["b"])
    xs = rnd(x * torch.sigmoid(a @ se["fc2"]["w"] + se["fc2"]["b"])[..., None])
    v = rnd(xs @ rnd(w["bilinear"]["w"]))
    i, j = torch.triu_indices(f, f, offset=1, device=x.device)
    pairs = xs[:, i] * v[:, j]
    return rnd(torch.cat([xs.reshape(b, -1), pairs.reshape(b, -1)], dim=-1))


def tower(w: dict, state: dict, h: torch.Tensor, *, train: bool, rate: float,
          gen: torch.Generator | None, rnd: Callable = identity) -> torch.Tensor:
    mlp = w["mlp"]
    for layer, st in zip(mlp["layers"], state["mlp"]["layers"]):
        h = _linear(layer["linear"], h, rnd)
        if train:  # the batch's statistics, taken at full precision
            mean, var = h.mean(0), h.var(0, unbiased=False)
        else:
            mean, var = st["bn_mean"], st["bn_var"]
        # each step of the normalisation in the tower's precision, as the
        # configuration computes it (and its backward, through ``rnd``)
        h = rnd(h - rnd(mean))
        h = rnd(h * rnd(torch.rsqrt(var + BN_EPS)))
        h = rnd(rnd(h * rnd(layer["bn_scale"])) + rnd(layer["bn_bias"]))
        h = torch.relu(h)
        if train and rate > 0.0:
            keep = 1.0 - rate
            mask = torch.rand(h.shape, generator=gen, device=h.device) < keep
            h = torch.where(mask, rnd(h / keep), torch.zeros((), device=h.device))
    return _linear(mlp["out"], h, rnd)[:, 0]


def logits(w: dict, state: dict, batch: dict, item_emb: torch.Tensor, sizes: dict, *,
           train: bool = False, gen: torch.Generator | None = None,
           rnd: Callable = identity) -> torch.Tensor:
    """Logits (B,) of a batch. In train mode ``gen`` is the step's dropout
    generator, freshly seeded: the encoder's seed is drawn from it first (SASRec
    models), then the tower's masks, layer by layer."""
    drop = None
    if train and sizes["seq_pooling"] == "attention" and sizes["attn_dropout"] > 0.0:
        seed = torch.randint(0, 2**63 - 1, (1,), generator=gen, dtype=torch.int64,
                             device=gen.device)
        drop = (seed, sizes["attn_dropout"])
    x = fields(w, batch, item_emb, sizes, rnd, drop)
    h = interaction(w, x, rnd)
    return tower(w, state, h, train=train, rate=sizes["net_dropout"], gen=gen, rnd=rnd)


def bce(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits."""
    y = y.float()
    return -(y * torch.nn.functional.logsigmoid(z)
             + (1.0 - y) * torch.nn.functional.logsigmoid(-z)).mean()


def probabilities(w: dict, state: dict, cols: dict, item_emb: torch.Tensor, sizes: dict, *,
                  rows: int = 16384, rnd: Callable = identity) -> torch.Tensor:
    """Eval-mode click probabilities of every row of ``cols``, ``rows`` at a
    time (BatchNorm's running statistics, no dropout)."""
    n = next(iter(cols.values())).shape[0]
    out = torch.empty(n, device=item_emb.device)
    with torch.no_grad():
        for a in range(0, n, rows):
            batch = {k: v[a:a + rows] for k, v in cols.items()}
            out[a:a + rows] = torch.sigmoid(logits(w, state, batch, item_emb, sizes, rnd=rnd))
    return out
