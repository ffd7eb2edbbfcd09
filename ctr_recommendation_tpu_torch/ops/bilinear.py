"""Bilinear field-pair interaction (FiBiNET).

  "all":  p_ij = v_i  * (v_j @ W)        shared W (E, E)
  "each": p_ij = (v_i @ W_i) * v_j       per-field W_i, i in [0, F-2]

over the F(F-1)/2 pairs i < j in the reference's nested-loop order
(model_fibinet.py:37-89: "all" projects the second operand, "each" the
first).
"""

from __future__ import annotations

import numpy as np
import torch

from ctr_recommendation_tpu_torch.ops.initializers import xavier_normal


def pair_indices(num_fields: int) -> tuple[np.ndarray, np.ndarray]:
    """Static (i, j) arrays for all pairs i < j, in np.triu_indices order."""
    i_idx, j_idx = np.triu_indices(num_fields, k=1)
    return i_idx.astype(np.int64), j_idx.astype(np.int64)


def inner_products(x: torch.Tensor) -> torch.Tensor:
    """x (B, F, E) -> the F(F-1)/2 inner products <x_i, x_j>, i < j, (B, P)
    fp32: the (B, F, F) Gram with fp32 accumulation (PNN's and DLRM's
    interaction), then its upper triangle in ``pair_indices`` order."""
    x32 = x.float()
    gram = torch.bmm(x32, x32.transpose(1, 2))
    i_idx, j_idx = pair_indices(x.shape[1])
    return gram[:, i_idx, j_idx]


def init(
    gen: torch.Generator, emb_dim: int, num_fields: int, bilinear_type: str = "all"
) -> dict:
    if bilinear_type == "all":
        return {"w": xavier_normal(gen, (emb_dim, emb_dim))}
    if bilinear_type == "each":
        w = torch.stack(
            [xavier_normal(gen, (emb_dim, emb_dim)) for _ in range(num_fields - 1)]
        )
        return {"w_each": w}  # (F-1, E, E)
    raise ValueError(f"bilinear_type must be 'all' or 'each', got {bilinear_type!r}")


def apply(params: dict, x: torch.Tensor, bilinear_type: str = "all") -> torch.Tensor:
    """x: (B, F, E) -> (B, F(F-1)/2, E) stacked pair interactions, in x's
    dtype (weights cast to it)."""
    i_idx, j_idx = pair_indices(x.shape[-2])
    if bilinear_type == "all":
        v = x @ params["w"].to(x.dtype)
        return x[..., i_idx, :] * v[..., j_idx, :]
    if bilinear_type == "each":
        v = torch.einsum("bfe,fed->bfd", x[..., :-1, :], params["w_each"].to(x.dtype))
        return v[..., i_idx, :] * x[..., j_idx, :]
    raise ValueError(f"bilinear_type must be 'all' or 'each', got {bilinear_type!r}")
