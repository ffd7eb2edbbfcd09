"""The cells' inputs, made on the device from the seed.

MicroLens-shaped rows with the distributions of the port's
``data/synthetic.py`` (its high-signal mode), rewritten for the device in a
few large calls a chunk: ids uniform (items in [1, item_vocab), levels in
[0, cate_vocab), users in [0, user_vocab)), histories of a uniform length
in the traffic's range, left-padded with the pad id 0, and a label drawn
from a planted logistic model over the observed item vector, the levels,
the item's popularity and the history's affinity to the candidate. The
item vectors are L2-normalised 128-d rows, correlated with the items'
latent factors; row 0 (the pad id) is zero.
"""

from __future__ import annotations

import math

import torch

LATENT = 8  # the planted model's item factors (data/synthetic.py's latent_dim)
CHUNK = 1 << 18  # rows made at a time
# the planted logit's components and their weights (synthetic.py, signal="high");
# the category-match term is left out
W_MM, W_LIKE, W_VIEW, W_POP, W_HIST = 3.5, 1.1, 1.1, 1.5, 0.8


class World:
    """The items: their factors, popularity, category effects and the
    observed item vectors, all on the device."""

    def __init__(self, gen: torch.Generator, sizes: dict, device):
        v, d = sizes["item_vocab"], sizes["mm_dim"]
        c = sizes["cate_vocab"]
        self.factors = torch.randn((v, LATENT), generator=gen, device=device) / math.sqrt(LATENT)
        self.factors[0] = 0.0
        self.pop = torch.randn((v,), generator=gen, device=device)
        proj = torch.randn((LATENT, d), generator=gen, device=device)
        mm = self.factors @ proj + 0.1 * torch.randn((v, d), generator=gen, device=device)
        self.item_emb = mm / mm.norm(dim=1, keepdim=True).clamp(min=1e-8)
        self.item_emb[0] = 0.0
        self.beta = torch.randn((d,), generator=gen, device=device)
        self.w_like = torch.randn((c,), generator=gen, device=device)
        self.w_view = torch.randn((c,), generator=gen, device=device)


def _hist_affinity(world: World, seq: torch.Tensor, item: torch.Tensor) -> torch.Tensor:
    mask = (seq != 0).float()
    hist = (world.factors[seq.long()] * mask[..., None]).sum(1) / mask.sum(1, keepdim=True).clamp(
        min=1.0)
    return (hist * world.factors[item.long()]).sum(-1)


def _std1(x: torch.Tensor) -> torch.Tensor:
    s = x.std(unbiased=False)
    return x / s if float(s) > 1e-12 else x


def rows(gen: torch.Generator, world: World, n: int, sizes: dict, hist_len, *, label: bool,
         device) -> dict[str, torch.Tensor]:
    """``n`` rows as int32 device columns (histories (n, max_len)), and a
    float32 ``label`` column when asked."""
    v, c, s = sizes["item_vocab"], sizes["cate_vocab"], sizes["max_len"]
    lo, hi = hist_len
    if not 0 <= lo <= hi <= s:
        raise ValueError(f"history lengths {hist_len} outside [0, max_len={s}]")
    i32 = torch.int32
    cols = {
        "user_id": torch.randint(0, sizes["user_vocab"], (n,), generator=gen, device=device,
                                 dtype=i32),
        "likes_level": torch.randint(0, c, (n,), generator=gen, device=device, dtype=i32),
        "views_level": torch.randint(0, c, (n,), generator=gen, device=device, dtype=i32),
        "item_id": torch.randint(1, v, (n,), generator=gen, device=device, dtype=i32),
        "item_seq": torch.empty((n, s), dtype=i32, device=device),
    }
    pos = torch.arange(s, device=device)[None, :]
    for a in range(0, n, CHUNK):
        z = min(n, a + CHUNK)
        lens = torch.randint(lo, hi + 1, (z - a,), generator=gen, device=device)
        seq = torch.randint(1, v, (z - a, s), generator=gen, device=device, dtype=i32)
        cols["item_seq"][a:z] = seq.masked_fill(pos < (s - lens)[:, None], 0)
    if label:
        item = cols["item_id"].long()
        hist = torch.empty(n, device=device)
        for a in range(0, n, CHUNK):
            z = min(n, a + CHUNK)
            hist[a:z] = _hist_affinity(world, cols["item_seq"][a:z], cols["item_id"][a:z])
        logit = (W_MM * _std1(world.item_emb[item] @ world.beta)
                 + W_LIKE * _std1(world.w_like[cols["likes_level"].long()])
                 + W_VIEW * _std1(world.w_view[cols["views_level"].long()])
                 + W_POP * _std1(world.pop[item]) + W_HIST * _std1(hist))
        logit = logit - logit.mean()
        u = torch.rand((n,), generator=gen, device=device)
        cols["label"] = (u < torch.sigmoid(logit)).float()
    return cols
