"""MaskNet, the parallel variant (Wang et al. 2021), the JAX package's
``models/masknet.py``: each MaskBlock computes an instance-guided mask from
the RAW flattened field embeddings through a bottleneck MLP
(``int(masknet_agg_ratio * F*E)`` wide), multiplies it into the
LayerNorm'd embeddings (one LayerNorm over each field's E, its affine shared
across fields), projects to a hidden vector, LayerNorm, ReLU and dropout;
the blocks' outputs concatenate into the logit head. No BatchNorm: the
model state is ``{}``.

Its dropout draws from the step generator; the masks cannot be JAX's
``fold_in(rng, 100 + i)`` ones, as the tower's cannot.
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.config.schema import ModelConfig
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap
from ctr_recommendation_tpu_torch.models import trunk
from ctr_recommendation_tpu_torch.ops import mlp as mlp_ops
from ctr_recommendation_tpu_torch.ops.attention import layer_norm
from ctr_recommendation_tpu_torch.ops.initializers import linear_apply, linear_init

SEQ_POOLING = "mean"
LN_EPS = 1e-5


def init(gen: torch.Generator, fm: FeatureMap, cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, {}) on the CPU, drawn from ``gen`` in a fixed order."""
    e = cfg.embedding_dim
    d = fm.num_fields * e
    agg = max(1, int(cfg.masknet_agg_ratio * d))
    bd = cfg.masknet_block_dim
    params: dict = {
        "trunk": trunk.init(gen, fm, cfg, seq_pooling=SEQ_POOLING),
        "ln_scale": torch.ones(e),
        "ln_bias": torch.zeros(e),
        "blocks": [],
    }
    for _ in range(cfg.masknet_blocks):
        params["blocks"].append({
            "mask1": linear_init(gen, d, agg),
            "mask2": linear_init(gen, agg, d),
            "hidden": linear_init(gen, d, bd),
            "hln_scale": torch.ones(bd),
            "hln_bias": torch.zeros(bd),
        })
    params["out"] = linear_init(gen, cfg.masknet_blocks * bd, 1)
    return params, {}


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
    """As ``din.apply`` (``weight`` is unused: no BatchNorm); the blocks in
    ``tower_dtype`` with both LayerNorms computed in fp32."""
    x = trunk.apply(params["trunk"], fm, cfg, batch, seq_pooling=SEQ_POOLING,
                    compute_dtype=compute_dtype, train=train, generator=generator, lookup=lookup)
    td = trunk.tower_dtype(cfg, compute_dtype)
    raw = x.flatten(1).to(td)  # the masks' input: the raw embeddings (the paper's)
    ln_emb = layer_norm(x.float(), params["ln_scale"], params["ln_bias"], LN_EPS).flatten(1).to(td)
    outs = []
    for blk in params["blocks"]:
        m = linear_apply(blk["mask2"], torch.relu(linear_apply(blk["mask1"], raw)))
        h = linear_apply(blk["hidden"], ln_emb * m)
        h = torch.relu(layer_norm(h.float(), blk["hln_scale"], blk["hln_bias"], LN_EPS).to(td))
        if train and cfg.net_dropout > 0.0 and generator is not None:
            h = mlp_ops.dropout(h, cfg.net_dropout, generator)
        outs.append(h)
    logits = linear_apply(params["out"], torch.cat(outs, dim=-1))
    return logits[..., 0].float(), {}
