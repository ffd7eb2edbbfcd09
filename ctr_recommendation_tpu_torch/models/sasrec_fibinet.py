"""SASRec-FiBiNET: attention pooling over the click history + FiBiNET.

The JAX package's ``models/sasrec_fibinet.py`` on the port: MM-FiBiNET
(``models/fibinet.py``) with the Hist field made by the SASRec encoder over
``item_seq`` and target-aware pooling (``ops/attention.py``) instead of the
masked mean. Trains and serves.
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.config.schema import ModelConfig
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap
from ctr_recommendation_tpu_torch.models import fibinet

SEQ_POOLING = "attention"


def init(gen: torch.Generator, fm: FeatureMap, cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, state) on the CPU, drawn from ``gen`` in a fixed order."""
    return fibinet.init(gen, fm, cfg, seq_pooling=SEQ_POOLING)


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
    """batch -> (logits (B,) fp32, new state), train or eval: the JAX
    package's ``sasrec_fibinet.apply`` (:39-67). The encoder runs on its
    kernels (forward and backward) and the interaction on its kernels when
    ``cfg.use_pallas`` is set (their plain versions on CPU tensors); in train
    mode the encoder's dropout seed and the tower's masks come from
    ``generator``; ``lookup`` replaces the trunk's embedding gather."""
    return fibinet.apply(
        params, state, fm, cfg, batch, train=train, generator=generator,
        compute_dtype=compute_dtype, weight=weight, seq_pooling=SEQ_POOLING, lookup=lookup,
    )
