"""MM-FiBiNET: SENet excitation + bilinear field-pair interaction + DNN tower
(the reference's model_fibinet.py:91-199), train and eval. Logits out; the
sigmoid lives at the loss and predict boundaries.
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.config.schema import ModelConfig
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap
from ctr_recommendation_tpu_torch.models import trunk
from ctr_recommendation_tpu_torch.ops import bilinear as bilinear_ops
from ctr_recommendation_tpu_torch.ops import mlp as mlp_ops
from ctr_recommendation_tpu_torch.ops import senet as senet_ops
from ctr_recommendation_tpu_torch.ops.interaction import senet_bilinear_concat
from ctr_recommendation_tpu_torch.utils.profiling import span, stage_boundary

SEQ_POOLING = "mean"


def init(
    gen: torch.Generator, fm: FeatureMap, cfg: ModelConfig, *, seq_pooling: str = SEQ_POOLING
) -> tuple[dict, dict]:
    """(params, state) on the CPU, drawn from ``gen`` in a fixed order."""
    f, e = fm.num_fields, cfg.embedding_dim
    params = {
        "trunk": trunk.init(gen, fm, cfg, seq_pooling=seq_pooling),
        "senet": senet_ops.init(gen, f, cfg.senet_reduction, cfg.senet_bias),
        "bilinear": bilinear_ops.init(gen, e, f, cfg.bilinear_type),
    }
    in_dim = (f + fm.num_pairs) * e
    params["mlp"], mlp_state = mlp_ops.init(
        gen, in_dim, cfg.hidden_units, out_dim=1, batch_norm=cfg.batch_norm
    )
    return params, {"mlp": mlp_state}


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
    seq_pooling: str = SEQ_POOLING,
    lookup=None,
) -> tuple[torch.Tensor, dict]:
    """batch -> (logits (B,) fp32, new_state). The interaction runs on the
    fused kernels (forward and backward) when ``cfg.use_pallas`` is set (their
    plain versions on CPU tensors); the tower runs in ``tower_dtype``. In
    train mode BatchNorm uses batch statistics (zero-``weight`` rows left
    out) and dropout (the tower's, and the attention encoder's under
    ``seq_pooling="attention"``) draws from ``generator``. ``lookup``
    replaces the trunk's embedding gather (``trunk.apply``). While a profiler
    runs, the interaction and the tower are spans and their backwards and
    the trunk's are the stages ``tower.bwd``, ``interaction.bwd`` and
    ``trunk.bwd`` (``utils/profiling.py``)."""
    x = trunk.apply(
        params["trunk"], fm, cfg, batch,
        seq_pooling=seq_pooling, compute_dtype=compute_dtype, train=train, generator=generator,
        lookup=lookup,
    )
    x = stage_boundary(x, "trunk.bwd")
    with span("interaction"):
        h = senet_bilinear_concat(
            params["senet"], params["bilinear"], x,
            bilinear_type=cfg.bilinear_type, use_kernel=cfg.use_pallas,
        )
    h = stage_boundary(h, "interaction.bwd")
    with span("tower"):
        logits, mlp_state = mlp_ops.apply(
            params["mlp"], state["mlp"], h.to(trunk.tower_dtype(cfg, compute_dtype)),
            train=train, dropout_rate=cfg.net_dropout, generator=generator, weight=weight,
        )
        logits = stage_boundary(logits[..., 0].float(), "tower.bwd")
    return logits, {"mlp": mlp_state}
