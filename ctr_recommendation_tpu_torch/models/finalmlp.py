"""FinalMLP (Mao et al., AAAI'23), the JAX package's ``models/finalmlp.py``
(BASELINE.json configs[3]): two MLP streams over the flattened fields, each
behind its own feature gate, fused by a multi-head bilinear head:

    g_k   = 2 * sigmoid(fc2(relu(fc1(flat))))        hidden 64
    s_k   = MLP_k(flat * g_k)                        headless BatchNorm towers
    logit = w1 s1 + w2 s2 + sum_h s1_h^T W_h s2_h

The JAX model casts ``flat`` to fp32, so the gates, streams and fusion run
in fp32 whatever ``tower_dtype`` says; so do they here.
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.config.schema import ModelConfig
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap
from ctr_recommendation_tpu_torch.models import trunk
from ctr_recommendation_tpu_torch.ops import mlp as mlp_ops
from ctr_recommendation_tpu_torch.ops.initializers import linear_apply, linear_init

SEQ_POOLING = "mean"
_GATE_HIDDEN = 64


def init(gen: torch.Generator, fm: FeatureMap, cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, state) on the CPU, drawn from ``gen`` in a fixed order."""
    in_dim = fm.num_fields * cfg.embedding_dim
    d1, d2 = cfg.finalmlp_stream1_units[-1], cfg.finalmlp_stream2_units[-1]
    h = cfg.finalmlp_num_heads
    if d1 % h or d2 % h:
        raise ValueError(f"stream dims ({d1},{d2}) not divisible by heads {h}")
    params: dict = {"trunk": trunk.init(gen, fm, cfg, seq_pooling=SEQ_POOLING)}
    state: dict = {}
    for gname in ("gate1", "gate2"):
        params[gname] = {"fc1": linear_init(gen, in_dim, _GATE_HIDDEN),
                         "fc2": linear_init(gen, _GATE_HIDDEN, in_dim)}
    for sname, units in (("stream1", cfg.finalmlp_stream1_units),
                         ("stream2", cfg.finalmlp_stream2_units)):
        params[sname], state[sname] = mlp_ops.init(
            gen, in_dim, units, out_dim=None, batch_norm=cfg.batch_norm)
    params["fusion"] = {
        "w1": linear_init(gen, d1, 1),
        "w2": linear_init(gen, d2, 1, use_bias=False),
        "w_bi": 0.01 * torch.randn(h, d1 // h, d2 // h, generator=gen),  # per-head bilinear
    }
    return params, state


def _gate(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(linear_apply(params["fc1"], x))
    return 2.0 * torch.sigmoid(linear_apply(params["fc2"], h))


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
    """As ``din.apply``, everything after the trunk in fp32. The bilinear
    fusion sums first over i (s1_h W_h), then over the head's j and the
    heads."""
    x = trunk.apply(params["trunk"], fm, cfg, batch, seq_pooling=SEQ_POOLING,
                    compute_dtype=compute_dtype, train=train, generator=generator, lookup=lookup)
    b = x.shape[0]
    flat = x.flatten(1).float()
    streams, new_state = [], {}
    for k in ("1", "2"):
        s, new_state["stream" + k] = mlp_ops.apply(
            params["stream" + k], state["stream" + k], flat * _gate(params["gate" + k], flat),
            train=train, dropout_rate=cfg.net_dropout, generator=generator, weight=weight,
        )
        streams.append(s)
    s1, s2 = streams
    fusion, h = params["fusion"], cfg.finalmlp_num_heads
    s1w = torch.einsum("bhi,hij->bhj", s1.reshape(b, h, -1), fusion["w_bi"])
    bi = (s1w * s2.reshape(b, h, -1)).sum((1, 2))
    logit = (linear_apply(fusion["w1"], s1)[..., 0] + linear_apply(fusion["w2"], s2)[..., 0]
             + bi)
    return logit, new_state
