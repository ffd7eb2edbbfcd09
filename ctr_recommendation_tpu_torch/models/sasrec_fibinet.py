"""SASRec-FiBiNET: attention pooling over the click history + FiBiNET.

The JAX package's ``models/sasrec_fibinet.py`` on the port: MM-FiBiNET
(``models/fibinet.py``) with the Hist field made by the SASRec encoder over
``item_seq`` and target-aware pooling (``ops/attention.py``) instead of the
masked mean. Eval only so far: training waits for the encoder's backward
kernel and its in-kernel dropout (ROADMAP.md queue 2 item 5).
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
) -> tuple[torch.Tensor, dict]:
    """batch -> (logits (B,) fp32, state), eval mode. The encoder runs on its
    kernel and the interaction on its kernel when ``cfg.use_pallas`` is set
    (their plain versions on CPU tensors)."""
    if train:
        raise NotImplementedError(
            "sasrec_fibinet training is not ported yet: it needs the encoder's backward "
            "kernel and in-kernel dropout (ROADMAP.md queue 2 item 5)"
        )
    return fibinet.apply(
        params, state, fm, cfg, batch, compute_dtype=compute_dtype, seq_pooling=SEQ_POOLING,
    )
