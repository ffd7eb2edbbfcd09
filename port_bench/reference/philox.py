"""A frozen copy of the draws the port's training step makes, so that the
reference applies the same dropout masks:

* ``step_seed``: the seed of the step's dropout generator (the trainer
  reseeds a generator on its device from (train seed + 1, step));
* ``encoder_keep``: the SASRec encoder's counter-based mask, element (t, c)
  of site (layer, branch) from Philox4x32-10 word c % 4 of the counter
  (t mod 2^32, c // 4, 2 layer + branch, 0) under the key (seed's low and
  high 32 bits), kept iff (word >> 8) 2^-24 >= rate in fp32.

Plain integer arithmetic in int64 tensors; nothing here comes from the port.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments


def step_seed(train_seed: int, step: int) -> int:
    """The 63-bit seed of step ``step``'s dropout generator."""
    return (((train_seed + 1) % (1 << 31)) << 31 | (step % (1 << 31))) % (1 << 63)


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product a * b, b < 2^32, a a
    32-bit constant, in int64 without overflow: b split in 16-bit halves."""
    b_lo, b_hi = b & 0xFFFF, b >> 16
    lo_part = a * b_lo  # < 2^48
    hi_part = a * b_hi  # < 2^48
    low = (lo_part + ((hi_part & 0xFFFF) << 16)) & _U32
    carry = (lo_part >> 32) + (hi_part >> 16) + (((lo_part & _U32) + ((hi_part & 0xFFFF) << 16))
                                                  >> 32)
    return carry & _U32, low


def philox4x32(ctr, key):
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def encoder_keep(seed: torch.Tensor, n_tokens: int, e: int, layer: int, branch: int,
                 rate: float, token0: int = 0) -> torch.Tensor:
    """Keep mask (n_tokens, e) bool of the encoder's dropout site (layer, branch)."""
    seed = seed.reshape(-1)[:1].to(torch.int64)
    dev = seed.device
    t = ((token0 + torch.arange(n_tokens, dtype=torch.int64, device=dev)) & _U32)[:, None]
    q = torch.arange(-(-e // 4), dtype=torch.int64, device=dev)[None, :]
    words = philox4x32(
        (t, q, torch.full((), 2 * layer + branch, dtype=torch.int64, device=dev),
         torch.zeros((), dtype=torch.int64, device=dev)),
        (seed & _U32, (seed >> 32) & _U32),
    )
    w = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(n_tokens, -1)[:, :e]
    u = (w >> 8).to(torch.float32) * 2.0**-24
    return u >= torch.tensor(rate, dtype=torch.float32, device=dev)
