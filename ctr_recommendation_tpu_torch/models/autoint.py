"""AutoInt+ (Song et al. 2019), the JAX package's ``models/autoint.py``: over
the (B, F, E) field stack, ``autoint_num_layers`` interacting layers of
multi-head self-attention across the F fields with a ReLU'd linear
residual, a linear logit head over their flattened output, plus the
BatchNorm MLP over the raw fields as a parallel deep tower.

The JAX layers multiply the activations by the fp32 weights uncast (``x @
layer["wq"]``), so type promotion runs every interacting layer in fp32 when
the trunk is bf16. PyTorch refuses a bf16 @ fp32 product: here the layers
take their input as fp32 explicitly, to the same effect.
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.config.schema import ModelConfig
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap
from ctr_recommendation_tpu_torch.models import trunk
from ctr_recommendation_tpu_torch.ops import mlp as mlp_ops
from ctr_recommendation_tpu_torch.ops.initializers import linear_apply, linear_init, xavier_normal

SEQ_POOLING = "mean"


def init(gen: torch.Generator, fm: FeatureMap, cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, state) on the CPU, drawn from ``gen`` in a fixed order."""
    e, heads = cfg.embedding_dim, cfg.autoint_num_heads
    if e % heads:
        raise ValueError(f"embedding_dim {e} not divisible by autoint_num_heads {heads}")
    params: dict = {"trunk": trunk.init(gen, fm, cfg, seq_pooling=SEQ_POOLING), "layers": []}
    for _ in range(cfg.autoint_num_layers):
        params["layers"].append({k: xavier_normal(gen, (e, e)) for k in ("wq", "wk", "wv", "wres")})
    params["head"] = linear_init(gen, fm.num_fields * e, 1)
    params["mlp"], mlp_state = mlp_ops.init(
        gen, fm.num_fields * e, cfg.hidden_units, out_dim=1, batch_norm=cfg.batch_norm
    )
    return params, {"mlp": mlp_state}


def interact(layer: dict, x: torch.Tensor, heads: int) -> torch.Tensor:
    """One interacting layer: (B, F, E) -> (B, F, E) fp32, whatever x's
    dtype. The attention logits are divided by sqrt(E / heads) taken in x's
    dtype, as the JAX layer takes it."""
    b, f, e = x.shape
    d = e // heads
    x32 = x.float()

    def split(h):  # (B, F, E) -> (B, heads, F, d)
        return h.reshape(b, f, heads, d).transpose(1, 2)

    q, k, v = (split(x32 @ layer[w]) for w in ("wq", "wk", "wv"))
    logits = torch.einsum("bhfd,bhgd->bhfg", q, k) / torch.sqrt(torch.tensor(float(d))).to(x.dtype)
    out = torch.einsum("bhfg,bhgd->bhfd", torch.softmax(logits, dim=-1), v)
    return torch.relu(out.transpose(1, 2).reshape(b, f, e) + x32 @ layer["wres"])


def apply(
    params: dict,
    state: dict,
    fm: FeatureMap,
    cfg: ModelConfig,
    batch: dict[str, torch.Tensor],
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    compute_dtype: torch.dtype = torch.float32,
    weight: torch.Tensor | None = None,
    lookup=None,
) -> tuple[torch.Tensor, dict]:
    """As ``din.apply``; the interacting layers and their head in fp32, the
    deep tower in ``tower_dtype``."""
    x = trunk.apply(params["trunk"], fm, cfg, batch, seq_pooling=SEQ_POOLING,
                    compute_dtype=compute_dtype, train=train, generator=generator, lookup=lookup)
    h = x
    for layer in params["layers"]:
        h = interact(layer, h, cfg.autoint_num_heads)
    attn_logit = linear_apply(params["head"], h.flatten(1).float())[..., 0]
    deep, mlp_state = mlp_ops.apply(
        params["mlp"], state["mlp"], x.flatten(1).to(trunk.tower_dtype(cfg, compute_dtype)),
        train=train, dropout_rate=cfg.net_dropout, generator=generator, weight=weight,
    )
    return attn_logit + deep[..., 0].float(), {"mlp": mlp_state}
